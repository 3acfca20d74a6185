"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. ``nvcc``
compiles it for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the root of the checkout, named by a hash of the
source, of every header ``csrc/*.cuh`` (sources include them with ``-I csrc``)
and of the flags, so an edited source or header is rebuilt and an unchanged
one is reused. The library is loaded with ``ctypes``. Nothing is compiled when this
module is imported; a build starts at a kernel's first use, or when a caller
asks for ``build(...)`` of several kernels at once (one ``nvcc`` process per
source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: the name carries a hash of the
    source, the shared headers (by file name and content) and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all running at once. Returns {name: compiler output} for the
    kernels compiled by this call (ptxas prints registers and spills).
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in dict.fromkeys(names):
        target = library_path(name)
        if target.exists():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True), tmp, target)
    logs, failures = {}, []
    for name, (proc, tmp, target) in running.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
