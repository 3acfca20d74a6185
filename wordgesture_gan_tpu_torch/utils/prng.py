"""The JAX package's random streams in PyTorch: threefry2x32 keys and the
draws of ``jax.random`` (``PRNGKey``, ``split``, ``fold_in``, ``random_bits``,
``uniform``, ``normal``, ``permutation``, ``randint``; ``choice`` without
replacement is a permutation's head), number for number, as the installed
JAX computes them with its default implementation (threefry2x32,
``jax_threefry_partitionable`` on, 32-bit mode) on the CPU.

A key is an int64 tensor of shape (2,) holding two uint32 words; a stack of
keys is (n, 2). Key arithmetic is a few words, so keys live on the host and
are hashed as Python ints. A draw lands on its key's device: for a CPU key
it is computed here (the plain version, and the oracle of the kernel: the
hash in numpy's wrapping uint32, the floats in torch); a key on a CUDA
device launches the hand-written kernel of ``ops/threefry.py``.

The semantics, from JAX's ``_src/prng.py`` and ``_src/random.py`` and the
HLO XLA's CPU backend compiles them to:

  * ``PRNGKey(seed)`` is ``[0, seed & 0xFFFFFFFF]`` (32-bit mode: the seed is
    an int32, whose logical shift by 32 is 0);
  * ``split(key, n)[i]`` and ``fold_in(key, i)`` both hash the counter pair
    (0, i) under the key: the two output words are the new key;
  * ``random_bits(key, shape)[j]`` hashes (0, j) over the flat index j and
    XORs the two output words;
  * ``uniform`` puts the top 23 bits under the exponent of 1.0, subtracts
    1, scales by ``max - min`` and adds ``min`` in one fused multiply-add
    (XLA contracts the two), and clamps below at ``min``;
  * ``normal`` is sqrt(2)·erfinv(u), u uniform on (nextafter(-1, 0), 1),
    with XLA's float32 erfinv (Giles' polynomials in w = -log1p(-u·u)),
    whose log1p and log are XLA's own polynomials (Cephes'), each
    multiply-add fused where XLA fuses it; torch's float32 ``sqrt`` on the
    CPU is not correctly rounded, so the plain version takes it in double;
  * ``permutation(key, n)`` sorts by fresh 32-bit keys, round after round
    (2 rounds from n = 1,626), stably: ``lax.sort_key_val`` keeps ties in
    their order;
  * ``randint`` folds two 32-bit draws into the range with JAX's uint32
    modular arithmetic.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter words (x0, x1) under key words
    (k0, k1): Python ints, or numpy uint32 arrays broadcast together; 20
    rounds, a key injection after every four."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def as_key(key) -> torch.Tensor:
    """A key as an int64 (2,) CPU tensor, from two uint32 words (a JAX key's
    data, a saved key)."""
    if not torch.is_tensor(key):
        key = torch.from_numpy(np.asarray(key).astype(np.int64))
    return key.to(device="cpu", dtype=torch.int64).reshape(2)


def _words(key: torch.Tensor) -> Tuple[int, int]:
    return int(key[0]), int(key[1])


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: (n, 2) keys (hashed as Python ints: a
    key is two words, and a train step splits a few dozen)."""
    k0, k1 = _words(key)
    return torch.tensor([threefry2x32(k0, k1, 0, i) for i in range(n)], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the key of counter (0, data)."""
    return torch.tensor(threefry2x32(*_words(key), 0, int(data) & MASK), dtype=torch.int64)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values; a stack of
    keys (n, 2) gives (n, *shape), row i drawn with key i."""
    shape = _shape(shape)
    if key.device.type == "cuda":
        from ..ops.threefry import threefry_draw
        return threefry_draw(key, shape, "bits")
    # The hash in numpy's uint32, whose arithmetic wraps as the kernel's
    # does: one thread, a few milliseconds for a train step's draws.
    keys = key.reshape(-1, 2).numpy().astype(np.uint32)
    j = np.arange(math.prod(shape), dtype=np.uint32)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], np.zeros_like(j), j)
    out = torch.from_numpy((y0 ^ y1).astype(np.int64))
    return out.reshape(*key.shape[:-1], *shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) floats from uint32 bits: the top 23 bits under 1.0's exponent,
    minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` as XLA's CPU backend computes a multiply feeding
    an add, fused: the product of two floats is exact in double, and the
    double sum rounded to float is the fused result (but for a rare double
    rounding, which the kernel reproduces by computing the same way)."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32) for v in (a, b, c))
    return (a.double() * b.double() + c.double()).float()


def _scale(unit: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    lo, hi = _f32(minval), _f32(maxval)
    return torch.maximum(fma(unit, hi - lo, lo), lo)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``; a stack
    of keys (n, 2) gives (n, *shape)."""
    shape = _shape(shape)
    if key.device.type == "cuda":
        from ..ops.threefry import threefry_draw
        return threefry_draw(key, shape, "uniform", minval, maxval)
    return _scale(_bits_to_unit(random_bits(key, shape)), minval, maxval)


# XLA's CPU log (Cephes logf) and log1p (Cephes' rational form below
# sqrt(2) - 1), with the multiply-adds XLA contracts.
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)


def xla_log(v: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log of positive normal floats."""
    x, e = torch.frexp(v)
    e = e.to(torch.float32)
    below = x < _f32(0.707106781186547524)
    tmp = torch.where(below, x, 0.0)
    x = x - 1.0
    e = e - below.to(torch.float32)
    x = x + tmp
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y, y1, y2 = fma(x, p[0], p[1]), fma(x, p[3], p[4]), fma(x, p[6], p[7])
    y, y1, y2 = fma(y, x, p[2]), fma(y1, x, p[5]), fma(y2, x, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, _f32(-2.12194440e-4) * e)
    r = fma(-x2, 0.5, x) + y
    return fma(0.693359375, e, r)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p."""
    d = torch.full_like(x, _LOG1P_DEN[0])
    n = torch.full_like(x, _LOG1P_NUM[0])
    for cd, cn in zip(_LOG1P_DEN[1:], _LOG1P_NUM[1:]):
        d, n = fma(d, x, cd), fma(n, x, cn)
    x2 = x * x
    small = x + fma(-0.5, x2, (x * x2) * (n / d))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, xla_log(x + 1.0))


# XLA's float32 erfinv: Giles' polynomials for w < 5 and w >= 5, highest
# degree first (the coefficients of the lowered HLO).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
SQRT2 = 1.41421354  # float32(sqrt(2))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv, operation for operation."""
    w = -xla_log1p((-x) * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, torch.where(lt, _f32(a), _f32(b)))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32); a stack of keys (n, 2)
    gives (n, *shape)."""
    shape = _shape(shape)
    if key.device.type == "cuda":
        from ..ops.threefry import threefry_draw
        return threefry_draw(key, shape, "normal", NORMAL_LO, 1.0)
    u = _scale(_bits_to_unit(random_bits(key, shape)), NORMAL_LO, 1.0)
    return _f32(SQRT2) * erf_inv(u)


def permutation(key: torch.Tensor, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)``: arange(n) sorted by fresh 32-bit
    keys, ``ceil(3·ln n / ln(2**32 - 1))`` rounds, ties kept in order; the
    sort keys are drawn and sorted on ``device``."""
    key = key.cpu()
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub.to(device), (n,)), stable=True).indices
        x = x[order]
    return x


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) as int64:
    two 32-bit draws (``split(key)``) folded into [minval, maxval) by JAX's
    uint32 modular arithmetic, drawn on ``device``."""
    k1, k2 = split(key.cpu())
    higher = random_bits(k1.to(device), shape)
    lower = random_bits(k2.to(device), shape)
    span = max(int(maxval) - int(minval), 1)
    multiplier = ((2 ** 16 % span) ** 2 & MASK) % span
    offset = ((higher % span) * multiplier) & MASK
    offset = ((offset + lower % span) & MASK) % span
    return int(minval) + offset
