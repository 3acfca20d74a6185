#!/usr/bin/env python3
"""Kernel 1 (the BiLSTM inference forward) of two checkouts, on one GPU.

    python3 tools/compare_inference_kernel.py OTHER_CHECKOUT [--dtype float32]

Builds ``csrc/bilstm_fused.cu`` of this checkout and of OTHER_CHECKOUT (its
``wordgesture_gan_tpu_torch/csrc``, with its own headers) into
``build/compare/``, runs both through this checkout's wrapper on the same
full-width inputs (4 layers, H=48, L=128, Z=32) at B in {1, 131, 512, 1024},
and prints per batch whether the outputs are bit-equal, then each library's
time at B=512 in the order other, this, this, other (CUDA events, 20 calls
each) and the card's name and power limit. Without a CUDA device it exits
non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from wordgesture_gan_tpu_torch.models.layers import BiLSTM  # noqa: E402
from wordgesture_gan_tpu_torch.utils import prng  # noqa: E402
from wordgesture_gan_tpu_torch.ops import bilstm_fused  # noqa: E402
from wordgesture_gan_tpu_torch.ops import build as kernel_build  # noqa: E402

OUT = ROOT / "build" / "compare"


def build(csrc: Path, name: str) -> Path:
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    lib = src / "lib.so"
    subprocess.run([kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-I", str(src), "-o",
                    str(lib), str(src / "bilstm_fused.cu")], check=True, capture_output=True)
    return lib


def use(lib: Path) -> None:
    kernel_build._loaded[bilstm_fused.KERNEL] = ctypes.CDLL(str(lib))
    bilstm_fused._library.cache_clear()


def time_ms(fn, iters: int = 20) -> float:
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_inference_kernel: no CUDA device", file=sys.stderr)
        return 2
    libs = {"other": build(args.other / "wordgesture_gan_tpu_torch" / "csrc", "other"),
            "this": build(kernel_build.CSRC_DIR, "this")}
    device, dtype = torch.device("cuda"), getattr(torch, args.dtype)
    stack = BiLSTM(2 + 32, 48, 4, prng.PRNGKey(0)).to(device).params()
    inputs = {}
    for batch in (1, 131, 512, 1024):
        rng = np.random.default_rng(batch)
        x = torch.from_numpy(rng.uniform(-1, 1, (batch, 128, 2)).astype(np.float32)).to(device)
        z = torch.from_numpy(rng.normal(size=(batch, 32)).astype(np.float32)).to(device)
        inputs[batch] = (x, z)
        out = {}
        for name, lib in libs.items():
            use(lib)
            out[name] = bilstm_fused.fused_bilstm_fwd(stack, x, 48, z, dtype=dtype)
        print(json.dumps({"batch": batch, "dtype": args.dtype,
                          "path": bilstm_fused.kernel_path(dtype, 48, 128, 4),
                          "bit_equal": torch.equal(out["other"], out["this"])}), flush=True)
    x, z = inputs[512]
    times = []
    for name in ("other", "this", "this", "other"):
        use(libs[name])
        times.append((name, time_ms(lambda: bilstm_fused.fused_bilstm_fwd(stack, x, 48, z,
                                                                          dtype=dtype))))
    print(json.dumps({"batch": 512, "dtype": args.dtype, "ms_in_order": times}), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
