"""What surrounds the inference kernels (kernel 1, ``ops/bilstm_fused.py``), on
the CPU: the rule that picks one of its three kernel paths, the sample tile,
the packed weights it shares with the training kernels (the offsets the
kernels compute, mirrored here), the scratch layout through which rows pass
between layers, the launch counters, and the naming of both BiLSTM libraries
by the shared header. The kernels themselves run only on the GPU
(tests/test_torch_cuda.py, chip_smoke.py). No JAX is imported here.
"""

import shutil

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu_torch.models.layers import BiLSTM
from wordgesture_gan_tpu_torch.ops import bilstm_fused, bilstm_train
from wordgesture_gan_tpu_torch.ops import build as kernel_build
from wordgesture_gan_tpu_torch.ops.bilstm_fused import (MMA_HIDDEN, SAMPLE_TILE, fused_bilstm_fwd,
                                                        kernel_path, packed_sizes, packed_weights,
                                                        sample_tile, scratch_row_offset,
                                                        scratch_shape, unpack_weights)
from wordgesture_gan_tpu_torch.utils import prng

CELL = ("w_ih", "w_hh", "b_ih", "b_hh")
DIRS = ("fwd", "bwd")


def _stack(hidden, layers, latent, seed=0):
    return BiLSTM(2 + latent, hidden, layers, prng.PRNGKey(seed)).params()


# -- the dispatch rule -------------------------------------------------------------------------

DISPATCH = [
    (torch.bfloat16, 48, "mma"), (torch.float32, 48, "fp32"),
    (torch.bfloat16, 32, "mma"), (torch.float32, 32, "fp32"),
    (torch.bfloat16, 16, "mma"), (torch.float32, 16, "fp32"),
    (torch.bfloat16, 8, "general"), (torch.float32, 8, "general"),
    (torch.bfloat16, 5, "general"), (torch.float32, 5, "general"),
    (torch.bfloat16, 64, "general"), (torch.float32, 64, "general"),
    (torch.bfloat16, 300, "general"), (torch.float32, 300, "general"),
]


@pytest.mark.parametrize("dtype,hidden,path", DISPATCH)
def test_kernel_path_is_a_function_of_dtype_and_hidden(dtype, hidden, path):
    assert kernel_path(dtype, hidden, 128, 4) == path
    # Neither the sequence length nor the depth changes the path.
    assert {kernel_path(dtype, hidden, s, n) for s in (1, 9, 128) for n in (1, 2, 4)} == {path}


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_kernel_path_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="compute dtype"):
        kernel_path(dtype, 48, 128, 4)


@pytest.mark.parametrize("seq,layers", [(0, 4), (128, 0)])
def test_kernel_path_refuses_empty_shapes(seq, layers):
    with pytest.raises(ValueError):
        kernel_path(torch.bfloat16, 48, seq, layers)
    with pytest.raises(ValueError):
        bilstm_train.kernel_path(torch.bfloat16, 48, seq, layers)


def test_paths_of_the_inference_and_training_kernels_share_their_hidden_sizes():
    assert MMA_HIDDEN == (16, 32, 48) and bilstm_train.MMA_HIDDEN is MMA_HIDDEN
    for hidden in (8, 16, 32, 48, 64):
        on = hidden in MMA_HIDDEN
        assert (kernel_path(torch.bfloat16, hidden, 128, 4) == "mma") == on
        assert (bilstm_train.kernel_path(torch.bfloat16, hidden, 128, 4) == "mma") == on
        assert (kernel_path(torch.float32, hidden, 128, 4) == "fp32") == on
        # The training pair's float32 kernels take the same sizes.
        assert (bilstm_train.kernel_path(torch.float32, hidden, 128, 4) == "fp32") == on


@pytest.mark.parametrize("batch,tile", [(1, 4), (7, 4), (8, 4), (131, 4), (264, 4), (265, 8),
                                        (512, 8), (1024, 8), (2048, 8)])
def test_sample_tile_is_a_function_of_dtype_and_batch(batch, tile):
    """float32: 4 samples per cluster while that fills no more than the
    card's 132 SMs (two CTAs per cluster), 8 above; bfloat16: always 8."""
    assert sample_tile(torch.float32, batch) == tile
    assert sample_tile(torch.bfloat16, batch) == SAMPLE_TILE == 8
    assert (2 * -(-batch // 4) <= 132) == (tile == 4)


# -- the packed weights kernel 1 reads are the ones kernel 2 reads -------------------------------


def _cell_offsets(layer, direction, hidden, latent):
    """``cell_offsets`` of csrc/bilstm_step.cuh, line by line."""
    g = 4 * hidden
    first = (2 + latent + hidden + 2) * g
    rest = (3 * hidden + 2) * g
    din = 2 + latent if layer == 0 else 2 * hidden
    cell = first if layer == 0 else rest
    w_ih = (0 if layer == 0 else 2 * first + (layer - 1) * 2 * rest) + direction * cell
    w_hh = w_ih + din * g
    b_ih = w_hh + hidden * g
    return {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_ih + g, "din": din}


@pytest.mark.parametrize("layers", [1, 2, 3, 4])
@pytest.mark.parametrize("latent", [0, 3, 32])
@pytest.mark.parametrize("hidden", [16, 48])
def test_kernel_offsets_address_the_packed_weights(hidden, latent, layers):
    stack = _stack(hidden, layers, latent, seed=hidden + latent + layers)
    flat32, flat16 = packed_weights(stack, torch.bfloat16)
    assert flat32.dtype == torch.float32 and flat16.dtype == torch.bfloat16
    assert flat32.numel() == sum(int(np.prod(s)) for s in packed_sizes(hidden, latent, layers))
    tree = unpack_weights(flat32, hidden, latent, layers)
    g = 4 * hidden
    for k in range(layers):
        for d, name in enumerate(DIRS):
            off = _cell_offsets(k, d, hidden, latent)
            cell = stack[k][name]
            assert off["din"] == cell["w_ih"].shape[0]
            for leaf, rows in (("w_ih", off["din"]), ("w_hh", hidden), ("b_ih", 1), ("b_hh", 1)):
                want = cell[leaf].detach().reshape(-1)
                got = flat32[off[leaf]:off[leaf] + rows * g]
                assert torch.equal(got, want), (k, name, leaf)
                assert torch.equal(tree[k][name][leaf].reshape(-1), want)
                assert torch.equal(flat16[off[leaf]:off[leaf] + rows * g], want.to(torch.bfloat16))
            # What a float32 chain thread (unit, quarter) loads: rows of its
            # quarter of k, the four gate columns of its unit.
            unit, kq, quarter = hidden - 1, 3, hidden // 4
            for gate in range(4):
                for i in (0, quarter - 1):
                    row = kq * quarter + i
                    assert flat32[off["w_hh"] + row * g + gate * hidden + unit] == \
                        cell["w_hh"][row, gate * hidden + unit]


def test_layout_helpers_are_one_object_in_both_modules():
    for name in ("packed_weights", "packed_sizes", "unpack_weights", "MMA_HIDDEN"):
        assert getattr(bilstm_train, name) is getattr(bilstm_fused, name), name
    assert bilstm_train.SAMPLE_TILE == bilstm_fused.SAMPLE_TILE == 8
    assert bilstm_train.kernel_weights is bilstm_fused.kernel_weights
    assert bilstm_train.sample_tile is bilstm_fused.sample_tile


# -- the scratch between layers ------------------------------------------------------------------


@pytest.mark.parametrize("batch,seq,hidden,tile", [(1, 3, 16, 8), (9, 5, 16, 8), (13, 4, 48, 4),
                                                   (16, 7, 32, 8), (5, 128, 48, 4)])
def test_scratch_rows_are_a_bijection_with_one_block_per_tile(batch, seq, hidden, tile):
    shape = scratch_shape(batch, seq, hidden, 4, tile)
    assert shape == (2, -(-batch // tile), seq, tile, 2 * hidden)
    per_buffer = int(np.prod(shape[1:]))
    width = 2 * hidden
    padded = shape[1] * tile                 # whole tiles: samples past the batch included
    offsets = np.array([[scratch_row_offset(s, p, seq, hidden, tile) for p in range(seq)]
                        for s in range(padded)])
    # Rows do not overlap and fill the buffer exactly.
    assert sorted(offsets.reshape(-1)) == list(range(0, per_buffer, width))
    # The offset is the index into a (tiles, L, tile, 2H) array.
    grid = np.arange(per_buffer).reshape(shape[1:])
    for s in (0, padded - 1, min(batch - 1, tile)):
        for p in (0, seq - 1):
            assert offsets[s, p] == grid[s // tile, p, s % tile, 0]
    # Each tile's rows are one contiguous block of L * tile * 2H elements, and
    # one position's rows of a tile are contiguous (one bulk copy).
    block = seq * tile * width
    for t in range(shape[1]):
        rows = offsets[t * tile:(t + 1) * tile]
        assert rows.min() == t * block and rows.max() == (t + 1) * block - width
        for p in range(seq):
            assert sorted(rows[:, p]) == list(range(rows[0, p], rows[0, p] + tile * width, width))


@pytest.mark.parametrize("layers,buffers", [(1, 0), (2, 1), (3, 2), (4, 2), (7, 2)])
def test_scratch_holds_two_buffers_at_most(layers, buffers):
    """Layer k under the top writes buffer k % 2 and reads (k - 1) % 2."""
    assert scratch_shape(512, 128, 48, layers, 8)[0] == buffers
    written = {k % 2 for k in range(layers - 1)}
    assert len(written) == buffers


# -- the launch counters --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [8, 16])
def test_launch_counters_per_path_stay_zero_on_cpu_calls(hidden, dtype):
    assert set(fused_bilstm_fwd.launches_by_path) == {"mma", "fp32", "general"}
    stack = _stack(hidden, 2, 4)
    before = dict(fused_bilstm_fwd.launches_by_path), fused_bilstm_fwd.launches
    out = fused_bilstm_fwd(stack, torch.zeros((3, 5, 2)), hidden, torch.zeros((3, 4)), dtype=dtype)
    assert out.shape == (3, 5, 2 * hidden) and out.dtype == dtype
    assert (dict(fused_bilstm_fwd.launches_by_path), fused_bilstm_fwd.launches) == before


# -- the built libraries' names -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bilstm_fused", "bilstm_train"])
def test_both_bilstm_libraries_are_renamed_when_the_step_header_changes(name, tmp_path,
                                                                         monkeypatch):
    """Both sources include csrc/bilstm_step.cuh, so an edit there must never
    reuse either library. Hashing only: no compiler is needed."""
    source = (kernel_build.CSRC_DIR / f"{name}.cu").read_text()
    assert '#include "bilstm_step.cuh"' in source
    csrc = tmp_path / "csrc"
    shutil.copytree(kernel_build.CSRC_DIR, csrc)
    monkeypatch.setattr(kernel_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    first = kernel_build.library_path(name)
    assert first.name.startswith(f"lib{name}-") and kernel_build.library_path(name) == first
    header = csrc / "bilstm_step.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert kernel_build.library_path(name) != first
    # The kernel with no BiLSTM in it shares the directory's headers too.
    assert kernel_build.library_path("dtw").name.startswith("libdtw-")
