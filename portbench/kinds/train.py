"""A training cell: one run of the configuration's recipe through the
program's trainer, ``train_gan`` (fixed length) or ``train_variable_gan``
(variable length), graphed (``RuntimeConfig(scan_epoch=True)``), at the
configuration's sizes.

Set-up makes the training set from the seed and trains epoch 1, which holds
the eager warm-up step and the capture of the step's CUDA graph. The window
runs from the end of epoch 1 to the end of the first epoch that ends past
``seconds``: every gesture trained in it over all of its time, epoch
boundaries (shuffle, key split, loss copy) included. The trainer is stopped
by an exception from its epoch callback. A traced run then profiles two
more epochs.

The check follows the run's first three steps. Epoch 1 goes through the
program's own scanned epoch in four calls (batches 0, 1, 2, then the rest:
the same steps, keys and graph as one call), so that the state can be read
after steps 1, 2 and 3; later epochs are the program's calls, untouched.
Step 1 is the graph's eager warm-up; steps 2 and 3 are replays of the
captured graph, the path the window times. The reference
(``reference/step.py``) works out the same three steps from the seed in
float32. The numbers compared (``compare``) hold step 1's and step 2's
losses, the first gradient (Adam's first moment after step 1), the replay's
own gradient (worked out from the first moments after steps 1 and 2), and
each parameter's change over the three steps, each gap taken by the worst
leaf; the replay's gradient also by its difference over the generator's and
encoder's leaves together.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import corpus, trace as tracing
from ..reference import step as ref_step
from ..reference.models import Precision

LOSSES = ("d1_loss", "d2_loss", "cycle1_total", "cycle2_total", "cycle2_rec")
SPAN = "portbench.traced"


class _Stop(Exception):
    """Ends the trainer from its epoch callback."""


def configs(cell: Dict):
    from wordgesture_gan_tpu_torch.configs import ModelConfig, RuntimeConfig, TrainingConfig

    spec = cell["model_config"]
    model = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in spec["model"].items()})
    training = TrainingConfig(**spec["training"])
    runtime = RuntimeConfig(scan_epoch=True, precision=spec["model"]["compute_dtype"])
    return model, training, runtime


def training_set(cell: Dict, seed: int):
    spec = cell["model_config"]
    return corpus.training_set(spec["data"]["train_gestures"], spec["model"]["seq_length"],
                               spec["data"]["lengths"], spec["data"]["max_per_word"], seed)


def _snapshot(state: Dict, part: str) -> Dict[str, torch.Tensor]:
    """{model.path: copy} of the state's parameters or first moments."""
    out = {}
    for m in ref_step.MODELS:
        tree = state[m]["params"] if part == "params" else state[m]["opt"]["mu"]
        for k, v in ref_step.leaves(tree).items():
            out[f"{m}.{k}"] = v.detach().float().clone()
    return out


class FirstSteps:
    """Wraps the program's scanned epoch for epoch 1 only: four calls, with
    the state read before step 1, the first moments after steps 1 and 2,
    the parameters after step 3, and the losses of the first three steps."""

    def __init__(self, module, name: str, n_check: int):
        self.module, self.name, self.n_check = module, name, n_check
        self.original = getattr(module, name)
        self.readings: Dict = {}
        self.graph = None
        setattr(module, name, self)

    def __call__(self, state, epoch_batches, lr, *args, **kwargs):
        setattr(self.module, self.name, self.original)    # later epochs: the program's call
        self.graph = kwargs.get("graph")
        n = next(iter(epoch_batches.values())).shape[0]
        if n <= self.n_check:
            raise ValueError(f"an epoch of {n} steps cannot hold the {self.n_check} checked")
        self.readings["p0"] = _snapshot(state, "params")
        cuts = list(range(self.n_check + 1)) + [n]
        traces: List[Dict[str, torch.Tensor]] = []
        for lo, hi in zip(cuts, cuts[1:]):
            _, t = self.original(state, {k: v[lo:hi] for k, v in epoch_batches.items()}, lr,
                                 *args, **kwargs)
            traces.append(t)
            if hi in (1, 2):
                self.readings[f"mu{hi}"] = _snapshot(state, "opt")
            if hi == self.n_check:
                self.readings["p3"] = _snapshot(state, "params")
        out = {k: torch.cat([t[k] for t in traces]) for k in traces[0]}
        self.readings["losses"] = {k: out[k][:self.n_check].tolist() for k in LOSSES}
        return state, out


def program_run(cell: Dict, seed: int, seconds: float, trace: bool, t0: float,
                device: str) -> Dict:
    """Set-up, window and (with ``trace``) the profiled epochs of one run."""
    from wordgesture_gan_tpu_torch.data.pipeline import GestureArrays
    from wordgesture_gan_tpu_torch.data.variable_length import VariableGestureArrays
    from wordgesture_gan_tpu_torch.train import gan_loop, variable_loop

    spec, traffic = cell["model_config"], cell["traffic_spec"]
    model, training, runtime = configs(cell)
    gestures, protos, lens, words = training_set(cell, seed)
    if spec["variable_length"]:
        ds = VariableGestureArrays(gestures, protos, lens.astype(np.int32), words)
        trainer, module, name = variable_loop.train_variable_gan, variable_loop, \
            "gan_train_epoch_masked"
    else:
        ds = GestureArrays(gestures, protos, words)
        trainer, module, name = gan_loop.train_gan, gan_loop, "gan_train_epoch"
    if device == "cuda":
        from wordgesture_gan_tpu_torch.ops.build import build
        build(["bilstm_fused", "bilstm_train", "threefry"])
        torch.cuda.reset_peak_memory_stats()
    steps_per_epoch = len(gestures) // training.batch_size
    per_epoch = steps_per_epoch * training.batch_size
    first = FirstSteps(module, name, int(traffic["check_steps"]))
    w: Dict = {"epochs": 0, "start": None, "end": None, "traced_epochs": 0}
    prof = {"p": None, "span": None}

    def on_epoch(epoch, state, losses):
        now = time.perf_counter()
        if epoch == 0:
            gc.collect()
            w["start"] = time.perf_counter()
            return
        if w["end"] is None:
            w["epochs"] += 1
            if now - w["start"] >= seconds:
                w["end"] = now
                if not trace:
                    raise _Stop
                prof["p"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof["p"].start()
                prof["span"] = torch.profiler.record_function(SPAN)
                prof["span"].__enter__()
            return
        w["traced_epochs"] += 1
        if w["traced_epochs"] == int(traffic["trace_epochs"]):
            prof["span"].__exit__(None, None, None)
            prof["p"].stop()
            raise _Stop

    try:
        trainer(ds, model, training, runtime, num_epochs=training.num_epochs, seed=seed,
                checkpoint_dir=None, epoch_callback=on_epoch, verbose=False, device=device)
    except _Stop:
        pass
    finally:
        if getattr(module, name) is first:
            setattr(module, name, first.original)
    if w["end"] is None:
        raise RuntimeError("the run ended before its window closed")
    window_s = w["end"] - w["start"]
    out = {"setup_s": w["start"] - t0, "window_s": window_s, "epochs": w["epochs"],
           "steps": w["epochs"] * steps_per_epoch, "gestures": w["epochs"] * per_epoch,
           "steps_per_epoch": steps_per_epoch, "readings": first.readings,
           "graph": first.graph, "data": (gestures, protos, lens, words)}
    if device == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    if trace:
        out["trace"] = tracing.from_profiler(prof["p"], SPAN)
        out["trace"]["steps"] = w["traced_epochs"] * steps_per_epoch
        prof["p"] = None
    return out


def reference_steps(cell: Dict, seed: int, data, device: str, precision: str = "float32",
                    half_from: Optional[int] = None) -> Dict:
    """The first ``check_steps`` steps of the run worked out again from the
    seed: {"p0", "mu1", "mu2", "p3": {leaf: tensor}, "losses": {name: [per
    step]}}. ``half_from`` plants a fault: from that step on (0: every step;
    1: the steps a graph replays) each step sees the first half of its batch
    only."""
    spec, traffic = cell["model_config"], cell["traffic_spec"]
    model, tc = spec["model"], spec["training"]
    gestures, protos, lens, words = data
    B, Z, n_c = tc["batch_size"], model["latent_dim"], tc["n_critic"]
    masked = spec["variable_length"]
    diversity = bool(tc.get("lambda_div") or tc.get("lambda_ms")) and not masked
    margin = ref_step.within_word_diversity(gestures, words) if diversity else None
    rows = ref_step.epoch_rows(seed, 0, len(gestures))
    state = ref_step.init_state(seed, model, device)
    lr = tc["learning_rate"]   # epoch 0 of the cosine schedule
    P = Precision(precision)
    out = {"p0": _snapshot(state, "params"), "losses": {k: [] for k in LOSSES}}
    rng = state["rng"]
    for i in range(int(traffic["check_steps"])):
        idx = rows[i * B:(i + 1) * B]
        batch = {"gesture": torch.from_numpy(gestures[idx]).to(device),
                 "prototype": torch.from_numpy(protos[idx]).to(device)}
        if masked:
            mask = (np.arange(model["seq_length"])[None] < lens[idx][:, None]).astype(np.float32)
            batch["mask"] = torch.from_numpy(mask).to(device)
        rng, keys = ref_step.step_keys(rng, n_c, diversity)
        noise = ref_step.step_noise(keys, B, Z, n_c, device)
        if half_from is not None and i >= half_from:
            batch = {k: v[:B // 2] for k, v in batch.items()}
            noise = {k: v[:, :B // 2] if k in ("z_rand", "eps_enc") else v[:B // 2]
                     for k, v in noise.items()}
        losses = ref_step.train_step(state, batch, noise, lr, model, tc, P, margin)
        for k in LOSSES:
            out["losses"][k].append(losses[k])
        if i in (0, 1):
            out[f"mu{i + 1}"] = _snapshot(state, "opt")
    out["p3"] = _snapshot(state, "params")
    return out


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _worst(got: Dict[str, float], want: Dict[str, float], keys) -> Tuple[float, str]:
    """(max over ``keys`` of |got - want| / max(want, median of want), its key)."""
    median = float(np.median([want[k] for k in keys]))
    return max((abs(got[k] - want[k]) / max(want[k], median), k) for k in keys)


def _replay_grads(d: Dict) -> Dict[str, torch.Tensor]:
    """Step 2's own gradient, as the optimizer took it, from the first
    moments after steps 1 and 2: (mu2 - β1·mu1) / (1 - β1)."""
    b1 = ref_step.ADAM_B1
    return {k: (d["mu2"][k] - b1 * d["mu1"][k]) / (1.0 - b1) for k in d["mu2"]}


def _relative_difference(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                         keys) -> float:
    """||got - want|| / ||want|| over the leaves ``keys`` taken together."""
    diff = sum(float(torch.sum((got[k].double() - want[k].double()) ** 2)) for k in keys)
    norm = sum(float(torch.sum(want[k].double() ** 2)) for k in keys)
    return (diff / norm) ** 0.5


def _loss_gap(got: Dict, want: Dict, steps) -> float:
    return max(abs(got["losses"][k][i] - want["losses"][k][i]) / max(abs(want["losses"][k][i]), 1.0)
               for k in LOSSES for i in steps)


def compare(got: Dict, want: Dict) -> Tuple[Dict[str, float], Dict]:
    """The numbers of a training cell's check, ``got`` against the
    reference's ``want``, and what else the comparison saw:

    loss_gap         max over the losses of step 1 (the eager warm-up) of
                     |got - want| / max(|want|, 1);
    replay_loss_gap  the same of step 2, the first replay of the graph;
    grad_gap         max over the generator's and encoder's leaves of the
                     gap of the norms of the first Adam moment after step 1,
                     (1 - β1) times the first gradient as the optimizer took
                     it, over the larger of the reference's norm and the
                     median leaf's;
    replay_grad_gap  the same of step 2's own gradient, (mu2 - β1·mu1) /
                     (1 - β1), the gradient the first replay computed;
    replay_grad_diff ||got - want|| / ||want|| of that gradient over the
                     generator's and encoder's leaves together: a gap of
                     norms is blind to a gradient of the right size from the
                     wrong rows (half of each batch left out keeps the
                     leaves' norms within a few tenths), a difference is not;
    change_gap       the gap of norms, as grad_gap's, of the change p3 - p0
                     over the three steps, taken over the leaves of all four
                     models whose first moment
                     in the reference is at least a thousandth of the median
                     leaf's (a leaf whose gradient is nought to rounding
                     moves under Adam by round-off alone).

    The critics' state after step 1 holds five updates, not the first
    gradient, and the losses of step 3 follow ten, where Adam, which moves
    a parameter by about the learning rate whatever its gradient, carries
    rounding forward: both are reported beside the numbers
    (``critic_grad_gap``, ``loss_gap_3_steps``), not compared, as is step
    1's ``grad_diff``, the level ``replay_grad_diff`` starts from."""
    mu_got, mu_want = _norms(got["mu1"]), _norms(want["mu1"])
    first = [k for k in mu_want if k.split(".")[0] in ("g", "e")]
    grad_gap, grad_leaf = _worst(mu_got, mu_want, first)
    rg_got, rg_want = _replay_grads(got), _replay_grads(want)
    rn_got, rn_want = _norms(rg_got), _norms(rg_want)
    replay_gap, replay_leaf = _worst(rn_got, rn_want, first)
    replay_diff = _relative_difference(rg_got, rg_want, first)
    critic_gap, critic_leaf = _worst(mu_got, mu_want, [k for k in mu_want if k not in first])
    median_mu = float(np.median(list(mu_want.values())))
    moving = [k for k in mu_want if mu_want[k] >= 1e-3 * median_mu]
    d_got = _norms({k: got["p3"][k] - got["p0"][k] for k in moving})
    d_want = _norms({k: want["p3"][k] - want["p0"][k] for k in moving})
    change_gap, change_leaf = _worst(d_got, d_want, moving)
    extra = {"loss_gap_3_steps": _loss_gap(got, want, range(len(want["losses"][LOSSES[0]]))),
             "critic_grad_gap": critic_gap,
             "grad_diff": _relative_difference(got["mu1"], want["mu1"], first),
             "worst_leaves": {"grad": grad_leaf, "replay_grad": replay_leaf,
                              "critic_grad": critic_leaf, "change": change_leaf},
             "left_out_of_change": sorted(set(mu_want) - set(moving))}
    return {"loss_gap": _loss_gap(got, want, [0]), "replay_loss_gap": _loss_gap(got, want, [1]),
            "grad_gap": grad_gap, "replay_grad_gap": replay_gap, "replay_grad_diff": replay_diff,
            "change_gap": change_gap}, extra


def run(cell: Dict, seed: int, seconds: float, trace: bool, t0: float, device: str) -> Dict:
    from wordgesture_gan_tpu_torch.ops.bilstm_fused import fused_bilstm_fwd
    from wordgesture_gan_tpu_torch.ops.bilstm_train import bilstm_train_bwd, bilstm_train_fwd
    from wordgesture_gan_tpu_torch.ops.threefry import threefry_draw

    r = program_run(cell, seed, seconds, trace, t0, device)
    readings, data, graph = r.pop("readings"), r.pop("data"), r.pop("graph")
    complete = all(k in readings for k in ("p0", "mu1", "mu2", "p3", "losses"))
    counters = {"bilstm_fused": dict(fused_bilstm_fwd.launches_by_path),
                "bilstm_train_fwd": dict(bilstm_train_fwd.launches_by_path),
                "bilstm_train_bwd": dict(bilstm_train_bwd.launches_by_path),
                "threefry": threefry_draw.launches}
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    want = reference_steps(cell, seed, data, device)
    numbers, extra = compare(readings, want) if complete else ({}, {})
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": int(cell["chips"]), "memory_peak_bytes": r.get("memory_peak_bytes", 0)}
    if trace:
        dev["busy_s"], dev["window_s"] = r["trace"]["busy_s"], r["trace"]["window_s"]
    info = {"workload": cell["name"], "seed": seed, "window_s": r["window_s"],
            "epochs": r["epochs"], "steps": r["steps"], "gestures": r["gestures"],
            "setup_s": r["setup_s"], "launches": counters,
            "graph": None if graph is None else {"captures": graph.captures,
                                                 "replays": graph.replays},
            "losses_first_steps": readings.get("losses"),
            "reference_losses": want["losses"], "check_extra": extra}
    if device == "cuda":
        from ..harness import card_info
        info["card"] = card_info(int(cell["chips"]))
        info["memory_peak_bytes"] = dev["memory_peak_bytes"]
    ctx = {"cell": cell, "setup_s": r["setup_s"],
           "window": {k: r[k] for k in ("window_s", "epochs", "steps", "gestures",
                                        "steps_per_epoch")},
           "trace": r.get("trace")}
    return {"ctx": ctx, "numbers": numbers, "complete": complete, "attempted": r["steps"],
            "failed": 0, "device": dev, "info": info}
