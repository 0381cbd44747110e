"""The tiled weight buffers of the wgmma kernels, on the CPU: the forward
trunk's (ops/fused_render.py::pack_tiles, read by csrc/mlp_fwd_sm90.cuh) holds
exactly pack_weights' bf16 weights, and the frozen-network backward's
(pack_tiles_dx, read by csrc/mlp_dx_sm90.cuh) exactly pack_weights_both's
(in, out) blocks, each in the order and the 128-byte swizzle the kernels'
bulk copies and wgmma descriptors assume, at both widths the kernels take."""

import numpy as np
import pytest
import torch

from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
from nope_nerf_torch.ops.fused_render import (_tile_dx_index, _tile_dx_layout, _tile_index,
                                              _tile_layout, pack_tiles, pack_tiles_dx,
                                              pack_weights, pack_weights_both)

torch.set_num_threads(2)


def unpack_tiles(tiles, D):
    """pack_tiles' buffer -> pack_weights' 14 bf16 weights stored (out, in):
    the tiling undone through its own index."""
    sizes = [N * K for _, N, K in _tile_layout(D)]
    flat = tiles.new_zeros(sum(sizes) + 1)
    flat[torch.as_tensor(_tile_index(D))] = tiles
    out = [None] * 14
    offset = 0
    for (i, N, K), size in zip(_tile_layout(D), sizes):
        out[i] = flat[offset:offset + size].view(K, N).t().contiguous()
        offset += size
    return out


def _packed(D):
    cfg = NerfConfig(hidden_dim=D)
    params = init_nerf_params(cfg, torch.Generator().manual_seed(D), device="cpu")
    return pack_tiles(params, cfg), pack_weights(params, cfg)


@pytest.mark.parametrize("D", [128, 256])
def test_unpacking_the_tiles_gives_pack_weights_blocks(D):
    (tiles, biases), (W, B) = _packed(D)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    for got, ref in zip(unpack_tiles(tiles, D), W):
        assert got.shape == ref.shape and torch.equal(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(biases, B))


@pytest.mark.parametrize("D", [128, 256])
def test_tile_buffer_follows_the_kernels_slice_order(D):
    """The byte counts of csrc/mlp_fwd_sm90.cuh's Tiles<D>: 2 + 8 D/64 slices
    of (D x 64), D/64 + 1 of (D/2 x 64), then the two heads of 8 rows."""
    (tiles, _), (W, _) = _packed(D)
    full, half = D * 64, D * 32                   # bf16 elements of a slice
    trunk = 2 + 8 * (D // 64)
    heads = trunk * full + (D // 64 + 1) * half
    assert tiles.numel() == heads + 8 * D + 8 * D // 2
    # w0 is slice 0, w1 starts at slice 1, w5 follows w4's D/64 slices, feat's
    # slices end the trunk; the rgb-hidden layer's first slice follows them
    starts = {0: 0, 1: full, 5: (1 + 4 * (D // 64)) * full, 10: (trunk - D // 64) * full,
              11: trunk * full, 12: trunk * full + (D // 64) * half, 9: heads,
              13: heads + 8 * D}
    for i, start in starts.items():
        w = W[i]
        rows = w.shape[0]
        block = tiles[start:start + rows * 64].view(rows, 8, 8)
        # row r's 16-byte chunk c sits at chunk c ^ (r % 8); columns past K are zero
        r = torch.arange(rows)
        for c in range(8):
            got = block[r, c ^ (r % 8)]
            ref = w[:, 8 * c:8 * c + 8] if 8 * c < w.shape[1] else torch.zeros(rows, 8,
                                                                                 dtype=w.dtype)
            assert torch.equal(got, ref), (i, c)


@pytest.mark.parametrize("D", [128, 256])
def test_padded_columns_of_the_direction_slice_are_zero(D):
    """w12 has 32 input columns; its slice is one 64-column block whose other
    half is zero (the kernel's product reads only the first two 16-column steps)."""
    (tiles, _), (W, _) = _packed(D)
    full, half = D * 64, D * 32
    start = (2 + 8 * (D // 64)) * full + (D // 64) * half
    block = tiles[start:start + half].view(D // 2, 8, 8).to(torch.float32).numpy()
    rows = np.arange(D // 2)
    for c in range(4, 8):
        assert not block[rows, c ^ (rows % 8)].any()
    assert block.any()


def unpack_tiles_dx(tiles_dx, D):
    """pack_tiles_dx's backward buffer -> the (in, out) blocks it holds, by
    pack_weights index: the tiling undone through its own index."""
    layout = _tile_dx_layout(D)
    sizes = [N * K for _, N, K in layout]
    flat = tiles_dx.new_zeros(sum(sizes) + 1)
    index = torch.as_tensor(_tile_dx_index(D))
    flat[index] = tiles_dx
    out, offset = {}, 0
    for (i, N, K), size in zip(layout, sizes):
        out[i] = flat[offset:offset + size].view(N, K)
        offset += size
    return out, index, sum(sizes)


@pytest.mark.parametrize("D", [128, 256])
def test_unpacking_the_dx_slices_gives_the_in_out_blocks(D):
    cfg = NerfConfig(hidden_dim=D)
    params = init_nerf_params(cfg, torch.Generator().manual_seed(D + 1), device="cpu")
    tiles, tiles_dx, biases = pack_tiles_dx(params, cfg)
    _, Wt, B = pack_weights_both(params, cfg)
    ref_tiles, ref_biases = pack_tiles(params, cfg)
    assert torch.equal(tiles, ref_tiles)                 # the forward buffer, as pack_tiles'
    assert all(torch.equal(a, b) for a, b in zip(biases, B))
    assert all(torch.equal(a, b) for a, b in zip(biases, ref_biases))
    assert tiles_dx.dtype == torch.bfloat16 and tiles_dx.is_contiguous()
    blocks, index, pad = unpack_tiles_dx(tiles_dx, D)
    assert sorted(blocks) == [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12]   # no head
    for i, got in blocks.items():
        assert got.shape == Wt[i].shape and torch.equal(got, Wt[i]), i
    # zero padding where K is short of a 64-column slice (none at these widths:
    # every output count is a multiple of 64), and every element read once
    padded = index == pad
    assert not tiles_dx[padded].to(torch.float32).any()
    assert int(padded.sum()) == sum(N * (-(-K // 64) * 64 - K) for _, N, K in _tile_dx_layout(D))
    assert torch.equal(torch.sort(index[~padded]).values, torch.arange(pad))


@pytest.mark.parametrize("D", [128, 256])
def test_dx_buffer_follows_the_chain_slice_order(D):
    """The byte counts of csrc/mlp_dx_sm90.cuh's TilesDx<D>: D/128 slices of
    w12 (32 rows), D/128 of w11 and 8 D/64 of the trunk (D rows), 2 D/64 of
    w0 and w5 (64 rows); each slice's row r holds 16-byte chunk c at c ^ (r % 8)."""
    cfg = NerfConfig(hidden_dim=D)
    params = init_nerf_params(cfg, torch.Generator().manual_seed(D + 2), device="cpu")
    _, tiles_dx, _ = pack_tiles_dx(params, cfg)
    _, Wt, _ = pack_weights_both(params, cfg)
    H = D // 2
    assert tiles_dx.numel() == (H // 64) * 32 * 64 + (H // 64 + 8 * (D // 64)) * D * 64 \
        + 2 * (D // 64) * 64 * 64
    offset = 0
    for i, N, K in _tile_dx_layout(D):
        for kb in range(K // 64):
            block = tiles_dx[offset:offset + N * 64].view(N, 8, 8)
            r = torch.arange(N)
            for c in range(8):
                assert torch.equal(block[r, c ^ (r % 8)], Wt[i][:, 64 * kb + 8 * c:64 * kb + 8 * c + 8]), (i, kb, c)
            offset += N * 64
    assert offset == tiles_dx.numel()
