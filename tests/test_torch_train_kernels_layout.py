"""What surrounds the tensor-core training kernels (kernels 2 and 3,
``ops/bilstm_train.py``), on the CPU: the packed weight layout the kernels
read, the two-term bfloat16 split of the float32 gate gradients and the
casting contract it keeps, the rule that picks a kernel path, and the naming
of built libraries by source and header content. The kernels themselves run
only on the GPU (tests/test_torch_cuda.py, chip_smoke.py).

Inputs come from numpy seeds. Tolerances: the split reproduces a float32
value to 2^-16 relative (two bf16 roundings: 2^-9 of 2^-9, with slack); the
plain backward fed ``hi + lo`` agrees with the float32 one to 1e-5 of each
gradient's largest magnitude, and fed a single bf16 rounding it must not
(that is the contract the kernels are held to).
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu_torch.models.layers import BiLSTM
from wordgesture_gan_tpu_torch.ops import build as kernel_build
from wordgesture_gan_tpu_torch.ops import bilstm_fused
from wordgesture_gan_tpu_torch.ops.bilstm_train import (MMA_HIDDEN, bilstm_train_bwd,
                                                        bilstm_train_bwd_plain, bilstm_train_fwd,
                                                        bilstm_train_fwd_plain, fp32_buffer_shapes,
                                                        fp32_dx_row_offset, fp32_dy_rows,
                                                        fp32_gate_row_offset, fp32_row_strides,
                                                        fp32_wgrad_splits,
                                                        kernel_path, packed_sizes, packed_weights,
                                                        sample_tile, split_hi_lo, unpack_weights)
from wordgesture_gan_tpu_torch.utils import prng

CELL = ("w_ih", "w_hh", "b_ih", "b_hh")
DIRS = ("fwd", "bwd")


def _stack(hidden, layers, latent, seed=0):
    return BiLSTM(2 + latent, hidden, layers, prng.PRNGKey(seed)).params()


# -- (a) the packed weights ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("hidden", [5, 16, 48])
def test_packed_weights_round_trip_to_the_model_layout(hidden, layers, dtype):
    latent = 4
    stack = _stack(hidden, layers, latent, seed=hidden + layers)
    flat32, flat = packed_weights(stack, dtype)
    assert flat32.dtype == torch.float32 and flat.dtype == dtype
    assert flat32.dim() == flat.dim() == 1 and flat.is_contiguous()
    # No padding: the buffer holds exactly the stack's values, so nothing but
    # weights (not even zeros) is added.
    n_values = sum(stack[k][d][name].numel() for k in range(layers) for d in DIRS for name in CELL)
    assert flat32.numel() == flat.numel() == n_values
    assert n_values == sum(int(np.prod(s)) for s in packed_sizes(hidden, latent, layers))
    for buffer, cast in ((flat32, torch.float32), (flat, dtype)):
        tree = unpack_weights(buffer, hidden, latent, layers)
        assert len(tree) == layers
        for k in range(layers):
            for d in DIRS:
                for name in CELL:
                    want = stack[k][d][name].detach().to(cast)
                    assert tree[k][d][name].shape == want.shape
                    assert torch.equal(tree[k][d][name], want), (k, d, name)


@pytest.mark.parametrize("hidden,latent,layers", [(16, 8, 2), (48, 32, 4), (5, 3, 3)])
def test_packed_offsets_follow_the_kernels_formula(hidden, latent, layers):
    """``cell_offsets`` of csrc/bilstm_step.cuh: a cell is w_ih, w_hh, b_ih,
    b_hh; layer 1's cells hold (2 + Z + H + 2)·4H values, the others
    (3H + 2)·4H; cells come layer by layer, forward direction first."""
    sizes = [int(np.prod(s)) for s in packed_sizes(hidden, latent, layers)]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    g = 4 * hidden
    first, rest = (2 + latent + hidden + 2) * g, (3 * hidden + 2) * g
    for layer in range(layers):
        for d in range(2):
            cell = first if layer == 0 else rest
            base = (0 if layer == 0 else 2 * first + (layer - 1) * 2 * rest) + d * cell
            din = 2 + latent if layer == 0 else 2 * hidden
            want = [base, base + din * g, base + (din + hidden) * g, base + (din + hidden + 1) * g]
            assert list(starts[(layer * 2 + d) * 4:(layer * 2 + d) * 4 + 4]) == want
    assert starts[-1] == 2 * first + (layers - 1) * 2 * rest


def test_unpack_refuses_a_buffer_of_the_wrong_size():
    flat32, _ = packed_weights(_stack(16, 2, 4), torch.float32)
    with pytest.raises(ValueError, match="packed weights"):
        unpack_weights(flat32[:-1], 16, 4, 2)


# -- (b) the split of the gate gradients and the contract it keeps --------------------------


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
def test_split_hi_lo_reproduces_float32(scale):
    rng = np.random.default_rng(1)
    t = torch.from_numpy((rng.normal(size=(64, 192)) * scale).astype(np.float32))
    hi, lo = split_hi_lo(t)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == lo.shape == t.shape
    back = hi.to(torch.float32) + lo.to(torch.float32)
    rel = ((back - t).abs() / t.abs().clamp_min(1e-30)).max().item()
    assert rel <= 2.0 ** -16, rel
    single = ((hi.to(torch.float32) - t).abs() / t.abs().clamp_min(1e-30)).max().item()
    assert single > 2.0 ** -11          # one rounding alone is a bf16 rounding
    zero_hi, zero_lo = split_hi_lo(torch.zeros(8))
    assert not zero_hi.any() and not zero_lo.any()


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def _all_rel(got, want, layers):
    grads, dx, dz = got
    grads_w, dx_w, dz_w = want
    errs = {"dx": _rel(dx, dx_w), "dz": _rel(dz, dz_w)}
    for k in range(layers):
        for d in DIRS:
            for name in CELL:
                errs[f"{k}.{d}.{name}"] = _rel(grads[k][d][name], grads_w[k][d][name])
    return errs


@pytest.mark.parametrize("hidden,layers,batch,seq", [(16, 2, 6, 12), (48, 3, 4, 10), (8, 1, 5, 7)])
def test_split_products_keep_the_float32_contract_and_one_rounding_does_not(hidden, layers, batch,
                                                                            seq):
    # Float32 as the compute dtype: the contract's other roundings (of the
    # gradient passed down, of dy) are then exact, so what is left is the
    # effect of how the gate gradients enter the products.
    latent, dtype = 4, torch.float32
    stack = _stack(hidden, layers, latent, seed=3)
    rng = np.random.default_rng(hidden + layers)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, seq, 2)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(batch, latent)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(batch, seq, 2 * hidden)).astype(np.float32))
    with torch.no_grad():
        _, res = bilstm_train_fwd_plain(stack, x, z, hidden, dtype)
        want = bilstm_train_bwd_plain(stack, x, z, res, dy, hidden, dtype)

        def two_terms(dg):
            hi, lo = split_hi_lo(dg)
            return hi.to(torch.float32) + lo.to(torch.float32)

        split = bilstm_train_bwd_plain(stack, x, z, res, dy, hidden, dtype, gate_grads=two_terms)
        rounded = bilstm_train_bwd_plain(stack, x, z, res, dy, hidden, dtype,
                                         gate_grads=lambda dg: dg.to(torch.bfloat16).to(torch.float32))
    errs = _all_rel(split, want, layers)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
    errs_rounded = _all_rel(rounded, want, layers)
    assert max(errs_rounded.values()) > 1e-4, max(errs_rounded.values())


# -- (c) the dispatch rule -------------------------------------------------------------------

# (dtype, H, L, layers) of every training-pair case tests/test_torch_cuda.py
# runs, the train step's and the too-wide stack, with the path each must take.
DISPATCH_CASES = [
    (torch.bfloat16, 48, 128, 4, "mma"), (torch.float32, 48, 128, 4, "fp32"),
    (torch.bfloat16, 16, 1, 1, "mma"), (torch.float32, 16, 1, 1, "fp32"),
    (torch.bfloat16, 5, 7, 3, "general"), (torch.float32, 5, 7, 3, "general"),
    (torch.bfloat16, 16, 9, 2, "mma"), (torch.float32, 16, 9, 2, "fp32"),
    (torch.bfloat16, 8, 4, 2, "general"), (torch.float32, 8, 4, 2, "general"),
    (torch.bfloat16, 32, 128, 4, "mma"), (torch.bfloat16, 64, 128, 4, "general"),
    (torch.float32, 300, 4, 1, "general"), (torch.bfloat16, 300, 4, 1, "general"),
    (torch.float32, 16, 12, 2, "fp32"),
]


@pytest.mark.parametrize("dtype,hidden,seq,layers,path", DISPATCH_CASES)
def test_kernel_path_is_a_function_of_dtype_and_shape(dtype, hidden, seq, layers, path):
    assert kernel_path(dtype, hidden, seq, layers) == path
    # Neither the sequence length nor the depth changes the path.
    assert {kernel_path(dtype, hidden, s, n) for s in (1, 9, 128) for n in (1, 4)} == {path}


def test_kernel_path_hidden_sizes_and_bad_shapes():
    assert MMA_HIDDEN == (16, 32, 48)
    assert all(h % 16 == 0 for h in MMA_HIDDEN)
    with pytest.raises(ValueError):
        kernel_path(torch.bfloat16, 48, 0, 4)
    with pytest.raises(ValueError):
        kernel_path(torch.bfloat16, 48, 128, 0)


def test_launch_counters_per_path_start_at_zero_and_cpu_calls_leave_them():
    stack = _stack(16, 1, 4)
    x, z = torch.zeros((2, 3, 2)), torch.zeros((2, 4))
    before = (dict(bilstm_train_fwd.launches_by_path), dict(bilstm_train_bwd.launches_by_path),
              bilstm_train_fwd.launches, bilstm_train_bwd.launches)
    assert set(before[0]) == set(before[1]) == {"mma", "fp32", "general"}
    _, res = bilstm_train_fwd(stack, x, z, 16, torch.bfloat16)
    bilstm_train_bwd(stack, x, z, res, torch.ones((2, 3, 32)), 16, torch.bfloat16)
    after = (dict(bilstm_train_fwd.launches_by_path), dict(bilstm_train_bwd.launches_by_path),
             bilstm_train_fwd.launches, bilstm_train_bwd.launches)
    assert after == before      # CPU tensors take the plain versions: no kernel launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,layers", [(16, 1), (48, 2), (8, 2)])
def test_cpu_calls_of_every_path_leave_the_counters_at_zero(hidden, layers, dtype):
    """The counters name the three paths; a fresh process has launched
    nothing, and a CPU call of the pair (whichever path its shape names on
    the card) runs the plain versions and counts nothing."""
    for counter in (bilstm_train_fwd, bilstm_train_bwd):
        assert set(counter.launches_by_path) == {"mma", "fp32", "general"}
        assert sum(counter.launches_by_path.values()) == counter.launches
    stack = _stack(hidden, layers, 4)
    x, z = torch.zeros((3, 5, 2)), torch.zeros((3, 4))
    before = [(c.launches, dict(c.launches_by_path)) for c in (bilstm_train_fwd, bilstm_train_bwd)]
    y, res = bilstm_train_fwd(stack, x, z, hidden, dtype)
    bilstm_train_bwd(stack, x, z, res, torch.ones((3, 5, 2 * hidden)), hidden, dtype)
    assert y.shape == (3, 5, 2 * hidden) and y.dtype == res.dtype == dtype
    after = [(c.launches, dict(c.launches_by_path)) for c in (bilstm_train_fwd, bilstm_train_bwd)]
    assert after == before


# -- the float32 path's layouts ------------------------------------------------------------------


@pytest.mark.parametrize("batch,tile", [(1, 4), (5, 4), (264, 4), (265, 8), (512, 8), (2048, 8)])
def test_float32_pair_takes_the_inference_kernels_sample_tile(batch, tile):
    """The float32 pair tiles its clusters as kernel 1's float32 kernel does
    (one rule, ops/bilstm_fused.py:sample_tile): 4 samples while 2 CTAs a
    tile fit the card's 132 SMs, else 8."""
    assert sample_tile is bilstm_fused.sample_tile
    assert sample_tile(torch.float32, batch) == tile
    assert (2 * -(-batch // 4) <= 132) == (tile == 4)


@pytest.mark.parametrize("hidden", [16, 32, 48])
def test_float32_row_strides_are_16_bytes_past_the_row(hidden):
    """``fp32_dx_stride`` / ``fp32_gate_block`` / ``fp32_gate_stride`` of
    csrc/bilstm_train.cu: multiples of 4 floats (rows and gate blocks stay
    16-byte aligned for bulk and cp.async copies); a row stride is 4 modulo
    32, so the four samples a warp writes land in four bank groups, and the
    four gate blocks the four quarters of a unit read at once start in four
    different groups of 4 banks."""
    strides = fp32_row_strides(hidden)
    assert strides == {"dx": hidden + 4, "gate_block": hidden + 4, "gates": 4 * hidden + 36}
    for stride in strides.values():
        assert stride % 4 == 0
    for stride in (strides["dx"], strides["gates"]):
        assert {(s * stride) % 32 // 8 for s in (0, 2, 4, 6)} == {0, 1, 2, 3}
    assert len({(kq * strides["gate_block"]) % 32 // 4 for kq in range(4)}) == 4
    assert 4 * strides["gate_block"] <= strides["gates"]


@pytest.mark.parametrize("batch,seq,hidden,tile", [(5, 3, 16, 4), (9, 4, 48, 8), (8, 2, 32, 8)])
def test_float32_dx_rows_are_a_bijection_with_one_block_per_position(batch, seq, hidden, tile):
    """The input-gradient buffers (2 ping-pong, 2 streams, 2 halves, tiles,
    L, tile, DX): every (buffer, stream, half, sample, position) row has its
    own DX floats, the rows fill the buffer, and one position's rows of a
    tile are one contiguous block (one bulk copy)."""
    shape = fp32_buffer_shapes(batch, seq, hidden, 3, 3, tile, 1)["dx"]
    tiles = -(-batch // tile)
    dx = hidden + 4
    assert shape == (2, 2, 2, tiles, seq, tile, dx)
    padded = tiles * tile
    offsets = sorted(fp32_dx_row_offset(b, p, h, seq, batch, hidden, tile, buffer=pp, stream=st)
                     for pp in range(2) for st in range(2) for h in range(2)
                     for b in range(padded) for p in range(seq))
    assert offsets == list(range(0, int(np.prod(shape)), dx))
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    for b in (0, padded - 1):
        for p in (0, seq - 1):
            assert fp32_dx_row_offset(b, p, 1, seq, batch, hidden, tile, buffer=1, stream=0) == \
                grid[1, 0, 1, b // tile, p, b % tile, 0]
    for t in range(tiles):
        rows = [fp32_dx_row_offset(t * tile + s, 1, 0, seq, batch, hidden, tile)
                for s in range(tile)]
        assert rows == list(range(rows[0], rows[0] + tile * dx, dx))


@pytest.mark.parametrize("batch,seq,hidden,tile", [(5, 3, 16, 4), (9, 4, 48, 8)])
def test_float32_dy_rows_place_each_value_where_the_sweep_reads_it(batch, seq, hidden, tile):
    rng = np.random.default_rng(batch)
    dy = torch.from_numpy(rng.normal(size=(batch, seq, 2 * hidden)).astype(np.float32))
    rows = fp32_dy_rows(dy, tile)
    assert rows.shape == fp32_buffer_shapes(batch, seq, hidden, 2, 1, tile, 1)["dy"]
    assert rows.dtype == torch.float32 and rows.is_contiguous()
    flat = rows.reshape(-1)
    want = torch.zeros_like(flat)
    for b in range(batch):
        for p in range(seq):
            for half in range(2):
                at = fp32_dx_row_offset(b, p, half, seq, batch, hidden, tile)
                want[at:at + hidden] = dy[b, p, half * hidden:(half + 1) * hidden]
    # Every value in place; samples past the batch and the padding are zero.
    assert torch.equal(flat, want)
    assert torch.equal(fp32_dy_rows(dy.to(torch.bfloat16), tile),
                       fp32_dy_rows(dy.to(torch.bfloat16).float(), tile))


@pytest.mark.parametrize("batch,seq,hidden,layers,tile", [(5, 3, 16, 2, 4), (17, 2, 48, 3, 8)])
def test_float32_gate_rows_are_the_products_rows(batch, seq, hidden, layers, tile):
    """Gate-gradient rows (layers·2, L, T, GS), T = whole tiles: per (layer,
    direction) the rows r = pos·T + sample follow one another (the product's
    row index), a tile's rows at one position are one block (the sweep's
    bulk store), and the rows fill the buffer."""
    shape = fp32_buffer_shapes(batch, seq, hidden, 2, layers, tile, 1)["gates"]
    padded = -(-batch // tile) * tile
    gs = 4 * hidden + 36
    assert shape == (2 * layers, seq, padded, gs)
    offsets = [fp32_gate_row_offset(k, d, p, b, seq, batch, hidden, tile)
               for k in range(layers) for d in range(2) for p in range(seq) for b in range(padded)]
    assert offsets == list(range(0, int(np.prod(shape)), gs))
    for k in range(layers):
        for d in range(2):
            base = fp32_gate_row_offset(k, d, 0, 0, seq, batch, hidden, tile)
            for r in (0, padded, seq * padded - 1):
                assert fp32_gate_row_offset(k, d, r // padded, r % padded, seq, batch, hidden,
                                            tile) == base + r * gs


@pytest.mark.parametrize("batch,tile,layers,splits", [(512, 8, 4, 13), (2048, 8, 4, 13),
                                                      (512, 8, 1, 64), (1, 4, 4, 1),
                                                      (9, 8, 2, 2), (264, 4, 3, 18)])
def test_float32_weight_gradient_splits_fill_one_wave(batch, tile, layers, splits):
    """The product's CTAs (2 directions x (3 operand parts above layer 1, one
    at it) x splits) fit the 2 x 132 resident slots of an H100 in one wave,
    as many as fit, and no split is under 1024 rows of the sum."""
    rows = 128 * -(-batch // tile) * tile
    got = fp32_wgrad_splits(rows, layers)
    assert got == splits
    busy = 2 * (3 * (layers - 1) + 1)
    assert got * busy <= 2 * 132
    assert got == 1 or rows // got >= 1024
    assert got == max(1, rows // 1024) or (got + 1) * busy > 2 * 132


@pytest.mark.parametrize("layers,latent", [(1, 8), (4, 32), (2, 0)])
def test_float32_partial_sums_are_what_the_last_pass_reads(layers, latent):
    """The partial sums share the tensor-core path's last pass
    (``train_bwd_assemble_kernel``): product splits of (3H, 4H) per (layer,
    direction), per-tile bias rows, prototype rows and z rows."""
    hidden, batch, tile, splits = 16, 13, 4, 3
    shapes = fp32_buffer_shapes(batch, 5, hidden, latent, layers, tile, splits)
    tiles, g = 4, 4 * hidden
    assert shapes["ws"] == (splits, 2 * layers, 3 * hidden, g)
    assert shapes["wsb"] == (tiles, 2 * layers, g)
    assert shapes["wsp"] == (tiles, 2, 2, g)
    assert shapes["wsz"] == (tiles, 2, max(latent, 1), g)
    assert shapes["dx"] == ((8,) if layers == 1 else (2, 2, 2, tiles, 5, tile, hidden + 4))


# -- the built libraries' names ----------------------------------------------------------------


def test_library_path_changes_with_source_and_headers(tmp_path, monkeypatch):
    """A library is named by the content of its source, of every shared
    header and of the flags, so editing a header never reuses a stale build.
    No compiler is needed for this."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kernel.cu").write_text('#include "step.cuh"\nint f() { return step(); }\n')
    (csrc / "other.cu").write_text("int g() { return 2; }\n")
    (csrc / "step.cuh").write_text("inline int step() { return 1; }\n")
    monkeypatch.setattr(kernel_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    first = kernel_build.library_path("kernel")
    assert first.parent == tmp_path / "build" and first.name.startswith("libkernel-")
    assert kernel_build.library_path("kernel") == first               # stable
    assert kernel_build.library_path("other").name.startswith("libother-")

    (csrc / "step.cuh").write_text("inline int step() { return 3; }\n")
    header_edited = kernel_build.library_path("kernel")
    assert header_edited != first
    (csrc / "extra.cuh").write_text("// a second header\n")
    header_added = kernel_build.library_path("kernel")
    assert header_added not in (first, header_edited)
    (csrc / "kernel.cu").write_text('#include "step.cuh"\nint f() { return step() + 1; }\n')
    assert kernel_build.library_path("kernel") not in (first, header_edited, header_added)
    monkeypatch.setattr(kernel_build, "NVCC_FLAGS", kernel_build.NVCC_FLAGS + ("-DX",))
    flagged = kernel_build.library_path("kernel")
    assert flagged not in (first, header_edited, header_added)


def test_real_sources_include_the_shared_step_header():
    """The training kernels' source includes csrc/bilstm_step.cuh, which the
    build hashes and finds through ``-I csrc``."""
    source = (kernel_build.CSRC_DIR / "bilstm_train.cu").read_text()
    assert '#include "bilstm_step.cuh"' in source
    assert (kernel_build.CSRC_DIR / "bilstm_step.cuh").is_file()
    assert kernel_build.library_path("bilstm_train").name.startswith("libbilstm_train-")
