"""A sampling cell: bulk synthesis through the program's sampling loop,
``generate_gestures`` (fixed length) or ``generate_variable_gestures``
(variable length, with masks), closed loop with one client.

Set-up makes a pool of prototypes (words drawn by frequency, lengths from
the configuration's distribution) and the generator's weights, drawn on the
card from the seed with PyTorch's default ranges in two calls, then warms
up the chunk shapes the jobs use. The window runs jobs back to back; a job
is the next slice of the pool, its size from a fixed set of quantiles of
the traffic's log-uniform range in an order drawn from the seed, its noise
seed drawn from the run's seed. A job's latency runs from the call to its
numpy result in hand. The window ends with the first pass over the job
sizes that ends past ``seconds``. A traced run then profiles ``trace_jobs`` more jobs.

The check: from every job of the window, ``sample_rows_per_job`` rows drawn
from the seed; the reference (``reference/models.py``, float32) works each
out again from its prototype, the job's seed (the chunk's key, the row's
place in the chunk's draw) and the weights, and the number compared is the
widest gap between a sampled value and the reference's.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import corpus, stats, trace as tracing
from ..reference import prng as ref_prng
from ..reference.models import Precision, exact_products, generator as ref_generator

SPAN = "portbench.traced"
JOB_SPAN = "host: in a sampling call, no traced operation"


def model_config(cell: Dict):
    from wordgesture_gan_tpu_torch.configs import ModelConfig

    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cell["model_config"]["model"].items()})


def _bound(path: str, tree_dict: Dict, key: str, t: torch.Tensor, model: Dict) -> float:
    """PyTorch's default range of a leaf: LSTM tensors ±1/sqrt(H), a dense
    weight (in, out) and its bias ±1/sqrt(in)."""
    if key in ("w_ih", "w_hh", "b_ih", "b_hh"):
        return 1.0 / math.sqrt(model["gen_hidden_dim"])
    if key == "w":
        return 1.0 / math.sqrt(t.shape[0])
    if key == "b":
        return 1.0 / math.sqrt(tree_dict["w"].shape[0])
    raise ValueError(f"no default range for {path}")


def make_weights(template: Dict, model: Dict, seed: int, device: str) -> Dict:
    """A tree shaped like ``template`` drawn from the seed on ``device``:
    one uniform draw for every ranged leaf, one normal draw for the
    positions (N(0, 0.02²)), layer norms at identity."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    out = _copy_tree(template, device)
    ranged, normal = [], []

    def walk(tree, path):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            if not torch.is_tensor(v):
                walk(v, f"{path}.{k}")
            elif k == "pos":
                normal.append((tree, k, 0.02))
            elif k not in ("scale", "bias"):
                ranged.append((tree, k, _bound(f"{path}.{k}", tree, k, v, model)))

    walk(out, "")
    for slots, draw in ((ranged, lambda n: torch.rand(n, generator=gen, device=device) * 2 - 1),
                        (normal, lambda n: torch.randn(n, generator=gen, device=device))):
        values, at = draw(sum(t[k].numel() for t, k, _ in slots)), 0
        for tree, k, scale in slots:
            n = tree[k].numel()
            tree[k] = (values[at:at + n] * scale).reshape(tree[k].shape)
            at += n
    return out


def _copy_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _copy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_tree(v, device) for v in tree]
    return tree.detach().to(device=device, dtype=torch.float32).clone()


def _load(module_tree: Dict, weights: Dict) -> None:
    """Copy ``weights`` into the generator's parameters, leaf by leaf."""
    from ..reference.step import leaves

    have, new = leaves(module_tree), leaves(weights)
    if set(have) != set(new):
        raise ValueError("the weights do not match the generator's parameters")
    with torch.no_grad():
        for k, p in have.items():
            p.copy_(new[k])


def job_plan(spec: Dict, rng: np.random.Generator, count: int) -> List[int]:
    """``count`` job sizes: the fixed set of quantiles of log-uniform
    [min, max], each pass over the set in an order drawn from ``rng``."""
    lo, hi, m = spec["min"], spec["max"], spec["count"]
    sizes = np.round(lo * (hi / lo) ** ((np.arange(m) + 0.5) / m)).astype(np.int64)
    out: List[int] = []
    while len(out) < count:
        out.extend(int(s) for s in rng.permutation(sizes))
    return out[:count]


def make_pool(cell: Dict, seed: int):
    spec, traffic = cell["model_config"], cell["traffic_spec"]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 2])
    n, L = int(traffic["pool"]), spec["model"]["seq_length"]
    ids = corpus.draw_words(rng, n)
    lens = corpus.lengths(n, spec["data"]["lengths"], rng)
    protos = corpus.prototypes(ids, lens, L)
    masks = (np.arange(L)[None] < lens[:, None]).astype(np.float32) \
        if spec["variable_length"] else None
    return protos, masks


class Jobs:
    """The run's job sequence, drawn from the seed."""

    def __init__(self, cell: Dict, seed: int, pool: int):
        traffic = cell["traffic_spec"]
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 3])
        self.per_pass = int(traffic["job_sizes"]["count"])
        self.sizes = job_plan(traffic["job_sizes"], self.rng, 1 << 16)
        self.pool, self.k, self.i, self.at = pool, int(traffic["sample_rows_per_job"]), 0, 0

    def next(self) -> Dict:
        n = self.sizes[self.i]
        self.i += 1
        if self.at + n > self.pool:
            self.at = 0
        job = {"n": n, "offset": self.at, "seed": int(self.rng.integers(0, 2 ** 31 - 1)),
               "rows": np.sort(self.rng.choice(n, size=min(self.k, n), replace=False))}
        self.at += n
        return job


def program_run(cell: Dict, seed: int, seconds: float, trace: bool, t0: float,
                device: str) -> Dict:
    from wordgesture_gan_tpu_torch.models.gan import Generator
    from wordgesture_gan_tpu_torch.train.gan_loop import generate_gestures
    from wordgesture_gan_tpu_torch.train.variable_loop import generate_variable_gestures

    spec, traffic = cell["model_config"], cell["traffic_spec"]
    config = model_config(cell)
    if device == "cuda":
        from wordgesture_gan_tpu_torch.ops.build import build
        build(["bilstm_fused", "threefry"])
    protos, masks = make_pool(cell, seed)
    gen = Generator(config)
    weights = make_weights(gen.tree(), spec["model"], seed, device)
    _load(gen.tree(), weights)
    gen = gen.to(device)
    batch, trunc = int(traffic["batch"]), float(traffic["truncation"])

    def call(job):
        sl = slice(job["offset"], job["offset"] + job["n"])
        if masks is None:
            return generate_gestures(gen, protos[sl], config, truncation=trunc, seed=job["seed"],
                                     batch=batch, device=device)
        return generate_variable_gestures(gen, protos[sl], masks[sl], config, truncation=trunc,
                                          seed=job["seed"], batch=batch, device=device)

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    jobs = Jobs(cell, seed, len(protos))
    # Warm-up: the largest and the smallest job, so that the device's
    # memory pool holds what every job of the window needs.
    for n in (max(jobs.sizes), min(jobs.sizes)):
        call({"n": n, "offset": 0, "seed": 0})
    gc.collect()
    done, failed = [], 0
    start = time.perf_counter()
    while True:
        job = jobs.next()
        a = time.perf_counter()
        out = call(job)
        b = time.perf_counter()
        job["ms"] = (b - a) * 1e3
        if out.shape != (job["n"], *protos.shape[1:]):
            failed += 1
        job["out"] = out[job["rows"]].copy()
        done.append(job)
        # The window holds whole passes over the job sizes: every run the
        # same work.
        if b - start >= seconds and jobs.i % jobs.per_pass == 0:
            break
    end = time.perf_counter()
    r = {"setup_s": start - t0, "window_s": end - start, "jobs": done, "failed": failed,
         "weights": weights, "protos": protos, "masks": masks}
    if device == "cuda":
        r["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    if trace:
        traced = [jobs.next() for _ in range(int(traffic["trace_jobs"]))]
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with prof:
            with torch.profiler.record_function(SPAN):
                for job in traced:
                    with torch.profiler.record_function(JOB_SPAN):
                        call(job)
        r["trace"] = tracing.from_profiler(prof, SPAN, "host: between sampling calls",
                                           (JOB_SPAN,))
        r["trace"]["job_sizes"] = [j["n"] for j in traced]
        r["trace"]["gestures"] = sum(j["n"] for j in traced)
    return r


def reference_rows(cell: Dict, r: Dict, device: str, precision: str = "float32",
                   block: int = 512) -> np.ndarray:
    """The sampled rows of every job worked out again: (rows, L, 3)."""
    spec, traffic = cell["model_config"], cell["traffic_spec"]
    Z = spec["model"]["latent_dim"]
    batch, trunc = int(traffic["batch"]), float(traffic["truncation"])
    idx, zs = [], []
    for job in r["jobs"]:
        chunk = min(batch, 1 << (job["n"] - 1).bit_length())
        key = ref_prng.PRNGKey(job["seed"])
        for row in job["rows"]:
            c, i = divmod(int(row), chunk)
            zs.append(ref_prng.normal(ref_prng.fold_in(key, c), (Z,), start=i * Z) * trunc)
            idx.append(job["offset"] + int(row))
    idx = np.array(idx)
    z = torch.stack(zs)
    P = Precision(precision)
    outs = []
    with torch.no_grad(), exact_products():
        for s in range(0, len(idx), block):
            rows = idx[s:s + block]
            proto = torch.from_numpy(r["protos"][rows]).to(device)
            mask = None if r["masks"] is None else torch.from_numpy(r["masks"][rows]).to(device)
            out = ref_generator(r["weights"], proto, z[s:s + block].to(device), spec["model"], P,
                                pad_mask=mask)
            if mask is not None:
                out = out * mask[:, :, None]
            outs.append(out.cpu())
    return torch.cat(outs).numpy()


def compare(r: Dict, want: np.ndarray) -> Tuple[Dict[str, float], Dict]:
    """widest_gap: the largest |sampled value - reference value|; beside it
    the mean gap."""
    gap = np.abs(np.concatenate([j["out"] for j in r["jobs"]]) - want)
    return {"widest_gap": float(gap.max())}, {"mean_gap": float(gap.mean())}


def run(cell: Dict, seed: int, seconds: float, trace: bool, t0: float, device: str) -> Dict:
    from wordgesture_gan_tpu_torch.ops.bilstm_fused import fused_bilstm_fwd
    from wordgesture_gan_tpu_torch.ops.threefry import threefry_draw

    r = program_run(cell, seed, seconds, trace, t0, device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    want = reference_rows(cell, r, device)
    numbers, extra = compare(r, want)
    ms = [j["ms"] for j in r["jobs"]]
    gestures = sum(j["n"] for j in r["jobs"])
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": int(cell["chips"]), "memory_peak_bytes": r.get("memory_peak_bytes", 0)}
    if trace:
        dev["busy_s"], dev["window_s"] = r["trace"]["busy_s"], r["trace"]["window_s"]
    info = {"workload": cell["name"], "seed": seed, "window_s": r["window_s"],
            "jobs": len(ms), "gestures": gestures, "setup_s": r["setup_s"],
            "p95_samples": len(ms), "beyond_p95": stats.beyond(ms, 95),
            "job_ms_median": stats.percentile(ms, 50), "sampled_rows": int(want.shape[0]),
            "check_extra": extra,
            "launches": {"bilstm_fused": dict(fused_bilstm_fwd.launches_by_path),
                         "threefry": threefry_draw.launches}}
    if device == "cuda":
        from ..harness import card_info
        info["card"] = card_info(int(cell["chips"]))
        info["memory_peak_bytes"] = dev["memory_peak_bytes"]
    ctx = {"cell": cell, "setup_s": r["setup_s"],
           "window": {"window_s": r["window_s"], "jobs": len(ms), "gestures": gestures,
                      "job_ms": ms, "job_sizes": [j["n"] for j in r["jobs"]]},
           "trace": r.get("trace")}
    return {"ctx": ctx, "numbers": numbers, "complete": r["failed"] == 0,
            "attempted": len(ms), "failed": r["failed"], "device": dev, "info": info}
