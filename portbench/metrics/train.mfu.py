"""The model's operations per step (every generator, encoder and critic
application of the step, forward and backward, from the configuration's
shapes: flops.train_step_flops) times the steps of the window, over the
window, as a percentage of the card's bfloat16 peak."""

from portbench.flops import PEAK_FLOPS, train_step_flops


def read(ctx):
    w, spec = ctx["window"], ctx["cell"]["model_config"]
    if "steps" not in w or not w["steps"]:
        return None
    flops = train_step_flops(spec["model"], spec["training"]) * w["steps"]
    return 100.0 * flops / w["window_s"] / PEAK_FLOPS[spec["model"]["compute_dtype"]]
