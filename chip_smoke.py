#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the serving path from ``wordgesture_gan_tpu_torch/csrc``
   (one nvcc per source, started together) and print ptxas' register report;
3. hold each kernel against its plain PyTorch version on the card at the
   flagship generator's full width (4 layers, H=48, L=128, Z=32) for
   B in {1, 131, 512, 2048}: float32 with TF32 off, tolerance 1e-4 abs;
   bfloat16 against the plain bfloat16 version, tolerance 2e-2 abs;
4. serve gestures through the entry point a user calls,
   ``wordgesture_gan_tpu_torch.generate.main``: seeded random full-width
   weights written as a JAX-layout npz, 8192 gestures over a word list at
   --batch 512, bfloat16, monotone time head. The output must be (N, 128, 3),
   finite, |x|, |y| <= 1, t monotone from 0 to 1, and the kernel's launch
   count (set to 0 just before) must show the run went through it. A small
   batch with injected noise is then compared with the CPU's plain path;
5. time the kernel, its plain version and one cuDNN ``torch.nn.LSTM`` call on
   the same weights (a yardstick the port never calls) at B=512 in bfloat16
   and float32 with CUDA events, and the entry point's gestures/s.

Output: timing lines as JSON, then the kernel table as one JSON line
({"kernels": [...]}), then the nvidia-smi line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from wordgesture_gan_tpu_torch import generate
from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.interop.from_jax import write_generator_npz
from wordgesture_gan_tpu_torch.keyboard import QWERTYKeyboard
from wordgesture_gan_tpu_torch.ops import build as kernel_build
from wordgesture_gan_tpu_torch.ops.bilstm_fused import fused_bilstm_fwd, fused_bilstm_fwd_plain
from wordgesture_gan_tpu_torch.train.checkpoint import load_generator
from wordgesture_gan_tpu_torch.train.gan_loop import generate_gestures
from wordgesture_gan_tpu_torch.utils.chunking import chunk_layout

HIDDEN, SEQ, LAYERS, LATENT = 48, 128, 4, 32
CHECK_BATCHES = (1, 131, 512, 2048)
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
SERVE_N, SERVE_BATCH = 8192, 512
TIME_BATCH = 512
# Peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W): HBM bytes/s,
# and FLOP/s by operand type (bf16 on the tensor cores, fp32 on the CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
WORDS = ("the quick brown fox jumps over lazy dog hello world gesture keyboard swipe "
         "typing model sample serve people time year good first would there their "
         "about which when make like just know take into your some could them see "
         "other than then now look only come over think also back after use two how "
         "our work well way even new want because any these give day most us").split()


def random_generator_tree(hidden: int, layers: int, latent: int, seed: int) -> dict:
    """JAX-layout generator params with PyTorch-default uniform init, from numpy."""
    rng = np.random.default_rng(seed)

    def uniform(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    lstm, d = [], 2 + latent
    for _ in range(layers):
        b = 1.0 / np.sqrt(hidden)
        lstm.append({direction: {"w_ih": uniform((d, 4 * hidden), b),
                                 "w_hh": uniform((hidden, 4 * hidden), b),
                                 "b_ih": uniform((4 * hidden,), b),
                                 "b_hh": uniform((4 * hidden,), b)}
                     for direction in ("fwd", "bwd")})
        d = 2 * hidden
    b = 1.0 / np.sqrt(2 * hidden)
    return {"lstm": lstm, "out": {"w": uniform((2 * hidden, 3), b), "b": uniform((3,), b)}}


def stack_on(tree: dict, device) -> list:
    return [{d: {k: torch.from_numpy(v).to(device) for k, v in layer[d].items()} for d in layer}
            for layer in tree["lstm"]]


def random_inputs(batch: int, seq: int, latent: int, seed: int, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, seq, 2)).astype(np.float32)).to(device)
    z = torch.from_numpy(rng.normal(size=(batch, latent)).astype(np.float32)).to(device)
    return x, z


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the current CUDA stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bilstm_bound_ms(batch: int, seq: int, hidden: int, layers: int, latent: int,
                    dtype: str) -> tuple:
    """Least time for the fused BiLSTM's work on an H100: (ms, "bytes" or
    "operations"). Operations: the gate products' multiply-adds, both
    directions, every step, plus the latent projection. Bytes: each input
    read once (prototype, z, weights), the output written once."""
    item = 2 if dtype == "bfloat16" else 4
    g = 4 * hidden
    flops = batch * 2 * (seq * 2 * g * (hidden + 2) + (layers - 1) * seq * 2 * g * 3 * hidden
                         + 2 * g * latent)
    weights = (2 * 2 * g + layers * 2 * hidden * g + (layers - 1) * 2 * 2 * hidden * g) * item \
        + (2 * latent * g + layers * 2 * g) * 4
    nbytes = batch * seq * 2 * item + batch * latent * 4 + weights + batch * seq * 2 * hidden * item
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernel(device, hidden=HIDDEN, seq=SEQ, layers=LAYERS, latent=LATENT,
                 batches=CHECK_BATCHES) -> list:
    """Phase 3: the kernel against its plain version, on the same inputs."""
    tree = random_generator_tree(hidden, layers, latent, seed=1)
    stack = stack_on(tree, device)
    results = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for batch in batches:
            x, z = random_inputs(batch, seq, latent, seed=batch, device=device)
            got = fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype)
            want = fused_bilstm_fwd_plain(stack, x, hidden, z, dtype=dtype)
            if device.type == "cuda":
                torch.cuda.synchronize()
            if got.shape != (batch, seq, 2 * hidden) or got.dtype != dtype:
                raise AssertionError(f"kernel output {tuple(got.shape)} {got.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            results.append({"dtype": dtype_name, "batch": batch, "max_abs_err": err,
                            "tolerance": TOLERANCE[dtype_name]})
            print(json.dumps({"check": "bilstm_fused vs plain", **results[-1]}), flush=True)
            if not err <= TOLERANCE[dtype_name]:
                raise AssertionError(f"bilstm_fused disagrees with its plain version: "
                                     f"{dtype_name} B={batch} max |err| {err} > "
                                     f"{TOLERANCE[dtype_name]}")
    return results


def check_gestures(gestures: np.ndarray, n: int, seq: int) -> None:
    if gestures.shape != (n, seq, 3):
        raise AssertionError(f"gestures shape {gestures.shape} != {(n, seq, 3)}")
    if not np.isfinite(gestures).all():
        raise AssertionError("non-finite gestures")
    if np.abs(gestures[..., :2]).max() > 1.0:
        raise AssertionError("|x|, |y| > 1")
    t = gestures[..., 2]
    if (np.diff(t, axis=1) < 0).any():
        raise AssertionError("time channel not monotone")
    if np.abs(t[:, 0]).max() != 0.0 or np.abs(t[:, -1] - 1.0).max() > 1e-5:
        raise AssertionError("time channel does not run from 0 to 1")


def serve(device, workdir: Path, n=SERVE_N, batch=SERVE_BATCH, hidden=HIDDEN, runs=2) -> dict:
    """Phase 4: the main path through the CLI entry point. The first run's
    kernel launches are counted; later runs time the steady state."""
    weights = workdir / "generator.npz"
    write_generator_npz(random_generator_tree(hidden, LAYERS, LATENT, seed=0), str(weights))
    (workdir / "run_meta.json").write_text(json.dumps({"gen_hidden_dim": hidden,
                                                       "time_head": "monotone"}))
    out = workdir / "gestures.npz"
    argv = ["--words", ",".join(WORDS), "--n", str(n), "--batch", str(batch),
            "--precision", "bfloat16", "--time-head", "monotone", "--seed", "0",
            "--weights", str(weights), "--checkpoint-dir", str(workdir), "--out", str(out),
            "--device", device.type]
    stats = []
    for run in range(runs):
        fused_bilstm_fwd.launches = 0
        stats.append(generate.main(argv))
        if run == 0:
            launches = fused_bilstm_fwd.launches
    with np.load(out) as data:
        if set(data.files) != {"gestures", "words", "prototypes"}:
            raise AssertionError(f"npz keys {data.files}")
        check_gestures(data["gestures"], n, SEQ)
    expected = chunk_layout(n, batch)[1]
    if device.type == "cuda" and launches != expected:
        raise AssertionError(f"bilstm_fused launched {launches} times, expected {expected}")

    # A small request with injected noise against the CPU's plain path.
    config = ModelConfig(time_head="monotone", compute_dtype="bfloat16", gen_hidden_dim=hidden)
    rng = np.random.default_rng(7)
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), 48)]
    kb = QWERTYKeyboard()
    protos = np.stack([kb.get_word_prototype(w, SEQ) for w in words])
    z = rng.normal(size=(len(words), LATENT)).astype(np.float32)
    model = load_generator(str(weights), config, device=device)
    got = generate_gestures(model, protos, model.config, batch=32, device=device, z=z)
    model_cpu = load_generator(str(weights), config, device="cpu")
    want = generate_gestures(model_cpu, protos, model_cpu.config, batch=32, device="cpu", z=z)
    err = float(np.abs(got - want).max())
    print(json.dumps({"check": "serving vs CPU plain path", "n": len(words),
                      "max_abs_err": err, "tolerance": TOLERANCE["bfloat16"]}), flush=True)
    if not err <= TOLERANCE["bfloat16"]:
        raise AssertionError(f"served gestures differ from the CPU path by {err}")
    if device.type == "cuda":
        kb_protos = np.stack([kb.get_word_prototype(WORDS[i % len(WORDS)], SEQ)
                              for i in range(n)])
        profile_serving(model, kb_protos, batch, device)
    return {"launches": launches, "chunks": expected, "runs": stats}


def profile_serving(model, protos: np.ndarray, batch: int, device) -> None:
    """Where the serving path's time goes: one steady ``generate_gestures``
    call under torch.profiler, device time summed by kernel name against the
    call's wall time."""

    generate_gestures(model, protos, model.config, batch=batch, device=device)   # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate_gestures(model, protos, model.config, batch=batch, device=device)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        # Device-side events only (kernels, copies): CPU ops also carry the
        # device time of the kernels they launched, which would count twice.
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            rows.append({"name": evt.key[:80], "count": evt.count,
                         "device_ms": evt.self_device_time_total / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    print(json.dumps({"profile": "generate_gestures", "n": len(protos), "batch": batch,
                      "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
                      "top": rows[:8]}), flush=True)


def time_kernel(device, dtype_name: str, batch=TIME_BATCH, hidden=HIDDEN, seq=SEQ,
                layers=LAYERS, latent=LATENT) -> dict:
    """Phase 5: kernel, plain version and cuDNN LSTM at one shape."""
    dtype = getattr(torch, dtype_name)
    tree = random_generator_tree(hidden, layers, latent, seed=2)
    stack = stack_on(tree, device)
    x, z = random_inputs(batch, seq, latent, seed=3, device=device)
    ms = time_ms(lambda: fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype), iters=20)
    plain_ms = time_ms(lambda: fused_bilstm_fwd_plain(stack, x, hidden, z, dtype=dtype),
                       iters=2, warmup=1)

    lstm = torch.nn.LSTM(2 + latent, hidden, num_layers=layers, bidirectional=True,
                         batch_first=True)
    with torch.no_grad():
        for k, layer in enumerate(tree["lstm"]):
            for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
                p = layer[direction]
                getattr(lstm, f"weight_ih_l{k}{suffix}").copy_(torch.from_numpy(p["w_ih"].T))
                getattr(lstm, f"weight_hh_l{k}{suffix}").copy_(torch.from_numpy(p["w_hh"].T))
                getattr(lstm, f"bias_ih_l{k}{suffix}").copy_(torch.from_numpy(p["b_ih"]))
                getattr(lstm, f"bias_hh_l{k}{suffix}").copy_(torch.from_numpy(p["b_hh"]))
    lstm = lstm.to(device=device, dtype=dtype)
    lstm.flatten_parameters()
    seq_in = torch.cat([x, z[:, None, :].expand(-1, seq, -1)], dim=-1).to(dtype)
    with torch.no_grad():
        library_ms = time_ms(lambda: lstm(seq_in), iters=20)
        lib_err = (lstm(seq_in)[0].float()
                   - fused_bilstm_fwd_plain(stack, x, hidden, z, dtype=dtype).float()).abs().max()
    bound_ms, bound_by = bilstm_bound_ms(batch, seq, hidden, layers, latent, dtype_name)
    row = {"dtype": dtype_name, "batch": batch, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_max_abs_diff": lib_err.item(),
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(json.dumps({"timing": "bilstm_fused", **row}), flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 references in full float32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0],
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                      "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}), flush=True)

    t0 = time.perf_counter()
    logs = kernel_build.build(["bilstm_fused"])
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}] {line.strip()}", flush=True)
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}), flush=True)

    checks = check_kernel(device)
    with tempfile.TemporaryDirectory() as tmp:
        served = serve(device, Path(tmp))
    steady = served["runs"][-1]
    print(json.dumps({"serving": "generate.main", "n": steady["n"], "batch": SERVE_BATCH,
                      "dtype": "bfloat16", "launches_first_run": served["launches"],
                      "chunks": served["chunks"],
                      "gestures_per_s_first_run": served["runs"][0]["gestures_per_s"],
                      "gestures_per_s": steady["gestures_per_s"],
                      "seconds": steady["seconds"]}), flush=True)
    timings = {name: time_kernel(device, name) for name in ("bfloat16", "float32")}

    main_t = timings["bfloat16"]
    kernels = [{
        "name": "bilstm_fused", "route": "cuda",
        "source": "wordgesture_gan_tpu_torch/csrc/bilstm_fused.cu",
        "replaces": "wordgesture_gan_tpu/ops/bilstm_fused.py:54",
        "launches": served["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"], "library_ms": main_t["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
