"""The generator's forward operations per gesture (flops.generator_flops)
times the gestures of the window, over the window, as a percentage of the
card's bfloat16 peak."""

from portbench.flops import PEAK_FLOPS, generator_flops


def read(ctx):
    w, spec = ctx["window"], ctx["cell"]["model_config"]
    if "jobs" not in w or not w["gestures"]:
        return None
    flops = generator_flops(spec["model"]) * w["gestures"]
    return 100.0 * flops / w["window_s"] / PEAK_FLOPS[spec["model"]["compute_dtype"]]
