#!/usr/bin/env python3
"""What holds the float32 backward (kernel 3's float32 path) back, on one GPU.

    python3 tools/ablate_fp32_backward.py

Builds variants of ``wordgesture_gan_tpu_torch/csrc/bilstm_train.cu`` with a
part of the work removed (into ``build/ablation/``, one nvcc per variant, all
started together), then times the float32 backward of the full-width stack
(4 layers, H=48, L=128, Z=32, B=512) with each, and the device time of its
reverse sweep and weight-gradient product under torch.profiler:

* ``no_side_product``: the sweep's side threads skip dx = W_ih . dg;
* ``no_chain_product``: the chain skips dh = W_hh . dg (dh stays 0);
* ``no_products``: both;
* ``rows16``: the weight-gradient product stages 16 rows of the sum, not 32.

The variants' gradients are wrong except ``rows16``'s (held against the
plain version, 1e-4). Prints one JSON line per variant and repetition, then
the card's name and power limit. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from wordgesture_gan_tpu_torch.models.layers import BiLSTM  # noqa: E402
from wordgesture_gan_tpu_torch.utils import prng  # noqa: E402
from wordgesture_gan_tpu_torch.ops import bilstm_train  # noqa: E402
from wordgesture_gan_tpu_torch.ops import build as kernel_build  # noqa: E402

OUT = ROOT / "build" / "ablation"
SIDE = ("        if (works) {\n          float acc[2][S];",
        "        if (works && false) {\n          float acc[2][S];")
CHAIN = ("        quarter_product<H, S, 1>(acc, w, dgo + kq * GB, GS);\n", "")
ROWS = ("constexpr int kFwRows = 32;", "constexpr int kFwRows = 16;")
VARIANTS = {"base": [], "no_side_product": [SIDE], "no_chain_product": [CHAIN],
            "no_products": [SIDE, CHAIN], "rows16": [ROWS]}


def build_variants() -> dict:
    nvcc = kernel_build.find_nvcc()
    running = {}
    for name, edits in VARIANTS.items():
        src = OUT / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(kernel_build.CSRC_DIR, src)
        text = (src / "bilstm_train.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        (src / "bilstm_train.cu").write_text(text)
        cmd = [nvcc, *kernel_build.NVCC_FLAGS, "-I", str(src), "-o", str(src / "lib.so"),
               str(src / "bilstm_train.cu")]
        running[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True)
    for name, proc in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: OUT / name / "lib.so" for name in VARIANTS}


def time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_fp32_backward: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libraries = build_variants()
    device = torch.device("cuda")
    f32 = torch.float32
    stack = BiLSTM(2 + 32, 48, 4, prng.PRNGKey(0)).to(device).params()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (512, 128, 2)).astype(np.float32)).to(device)
    z = torch.from_numpy(rng.normal(size=(512, 32)).astype(np.float32)).to(device)
    dy = torch.from_numpy(rng.normal(size=(512, 128, 96)).astype(np.float32)).to(device)
    _, res = bilstm_train.bilstm_train_fwd(stack, x, z, 48, f32)
    want = bilstm_train.bilstm_train_bwd_plain(stack, x, z, res, dy, 48, f32)[0]

    def backward():
        return bilstm_train._launch_bwd_fp32(stack, x, z, res, dy, 48, f32)

    for rep in range(2):
        for name, path in libraries.items():
            kernel_build._loaded[bilstm_train.KERNEL] = ctypes.CDLL(str(path))
            bilstm_train._library.cache_clear()
            grads = backward()[0]
            err = max(((grads[k][d][leaf] - want[k][d][leaf]).abs().max()
                       / want[k][d][leaf].abs().max()).item()
                      for k in range(4) for d in ("fwd", "bwd") for leaf in ("w_ih", "w_hh"))
            ms = time_ms(backward)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    backward()
                torch.cuda.synchronize()
            passes = {e.key.split("::")[-1].split("<")[0]: e.self_device_time_total / e.count / 1e3
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0 and "train_bwd" in e.key}
            print(json.dumps({"variant": name, "repetition": rep, "bwd_ms": ms,
                              "ms_per_launch": passes, "max_rel_err": err}), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
