"""ctypes binding for the native C++ swipelog parser (host parsing, not a
device kernel; the port's copy of the JAX package's ``data/native.py``).

The shared library is built with g++ at first use from the port's own
``csrc/swipelog_parser.cpp`` into ``build/torch_kernels/`` (named by a hash of
the source). Where g++ or the library is unavailable the pure-Python parser
is the route: ``parse_log_file_native`` then returns None and the caller
parses with ``parse.parse_log_file``, which gives the same word →
[RawGesture] mapping.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..ops.build import BUILD_DIR, CSRC_DIR
from .parse import RawGesture

_SOURCE = CSRC_DIR / "swipelog_parser.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


class _ParseResult(ctypes.Structure):
    _fields_ = [
        ("points", ctypes.POINTER(ctypes.c_double)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("kb_dims", ctypes.POINTER(ctypes.c_double)),
        ("words", ctypes.POINTER(ctypes.c_char)),
        ("word_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_gestures", ctypes.c_int64),
        ("n_points", ctypes.c_int64),
    ]


def _build_library() -> Optional[Path]:
    if not _SOURCE.exists():
        return None
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    target = BUILD_DIR / f"libswipelog_parser-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(_SOURCE), "-o",
                        str(tmp)], check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return target
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = _build_library()
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.parse_swipelog.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                           ctypes.POINTER(_ParseResult)]
            lib.parse_swipelog.restype = ctypes.c_int
            lib.free_parse_result.argtypes = [ctypes.POINTER(_ParseResult)]
            lib.free_parse_result.restype = None
            _lib = lib
            return lib
        except OSError:
            _build_failed = True
            return None


def native_parser_available() -> bool:
    return _load() is not None


def parse_log_file_native(log_content: str) -> Optional[Dict[str, List[RawGesture]]]:
    """Parse with the C++ parser; None when the native library is unavailable
    (the caller then parses with the Python parser)."""
    lib = _load()
    if lib is None:
        return None

    data = log_content.encode("utf-8", errors="surrogateescape")
    result = _ParseResult()
    rc = lib.parse_swipelog(data, len(data), ctypes.byref(result))
    if rc != 0:
        return None
    try:
        n = int(result.n_gestures)
        if n == 0:
            return {}
        n_pts = int(result.n_points)
        points = np.ctypeslib.as_array(result.points, shape=(n_pts * 3,)).reshape(-1, 3).copy()
        offsets = np.ctypeslib.as_array(result.offsets, shape=(n + 1,)).copy()
        kb = np.ctypeslib.as_array(result.kb_dims, shape=(n * 2,)).reshape(-1, 2).copy()
        word_offsets = np.ctypeslib.as_array(result.word_offsets, shape=(n + 1,)).copy()
        words_blob = ctypes.string_at(result.words, int(word_offsets[-1]))
    finally:
        lib.free_parse_result(ctypes.byref(result))

    out: Dict[str, List[RawGesture]] = {}
    for i in range(n):
        word = words_blob[word_offsets[i]:word_offsets[i + 1]].decode("utf-8", "replace")
        pts = points[offsets[i]:offsets[i + 1]]
        out.setdefault(word, []).append(RawGesture(pts, float(kb[i, 0]), float(kb[i, 1])))
    return out
