"""The tiled weight buffers of the wgmma kernels, on the CPU: the forward
trunk's (ops/fused_render.py::pack_tiles, read by csrc/mlp_fwd_sm90.cuh at
hidden_dim 128 and 256, by csrc/mlp_fwd_wide_sm90.cuh at 384 and 512 and by
csrc/mlp_fwd_xwide_sm90.cuh, pass by pass, at 640 to 1024) holds
exactly pack_weights' bf16 weights, and the frozen-network backward's
(pack_tiles_dx, read by csrc/mlp_dx_sm90.cuh) exactly pack_weights_both's
(in, out) blocks, each in the order and the swizzle the kernels' bulk copies
and wgmma descriptors assume (64-column slices in the 128-byte swizzle; the
wide trunk's 32-column slices in the 64-byte one), at every width the kernels
take."""

import hashlib

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


@pytest.mark.parametrize("D", [128, 256, 384, 512, 640, 1024])
def test_unpacking_the_tiles_gives_pack_weights_blocks(D):
    (tiles, biases), (W, B) = _packed(D)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    for got, ref in zip(unpack_tiles(tiles, D), W):
        assert got.shape == ref.shape and torch.equal(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(biases, B))


@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_tile_buffer_follows_the_kernels_slice_order(D):
    """The byte counts of csrc/mlp_fwd_sm90.cuh's Tiles<D> (C = 64 columns a
    slice) and of csrc/mlp_fwd_wide_sm90.cuh's TilesW<D> (C = 32 at 384 and
    512): 2 (64/C) + 8 D/C slices of (D x C), D/C + 1 of (D/2 x C), then the
    two heads of 8 rows in 64-column blocks. Each slice's row r holds its
    16-byte chunk c at c ^ (r % 8) (C = 64) or c ^ ((r / 2) % 4) (C = 32)."""
    (tiles, _), (W, _) = _packed(D)
    C = 64 if D <= 256 else 32
    chunks = C // 8
    full, half = D * C, D // 2 * C                # bf16 elements of a slice
    pe_slices = 64 // C
    trunk = 2 * pe_slices + 8 * (D // C)
    heads = trunk * full + (D // C + 1) * half
    assert tiles.numel() == heads + 8 * D + 8 * D // 2
    # w0 is slice 0, w1 follows its pe_slices, w5 follows w4's D/C slices, feat's
    # slices end the trunk; the rgb-hidden layer's first slice follows them
    starts = {0: 0, 1: pe_slices * full, 5: (pe_slices + 4 * (D // C)) * full,
              10: (trunk - D // C) * full, 11: trunk * full,
              12: trunk * full + (D // C) * half}
    for i, start in starts.items():
        w = W[i]
        rows = w.shape[0]
        for kb in range(min(2, -(-w.shape[1] // C))):   # the weight's first slices
            block = tiles[start + kb * rows * C:start + (kb + 1) * rows * C].view(rows, chunks, 8)
            r = torch.arange(rows)
            swizzle = (2 * C * r // 128) % chunks
            for c in range(chunks):
                col = kb * C + 8 * c
                ref = (w[:, col:col + 8] if col < w.shape[1]
                       else torch.zeros(rows, 8, dtype=w.dtype))   # columns past K are zero
                assert torch.equal(block[r, c ^ swizzle], ref), (i, kb, c)
    # the heads: 64-column blocks of 8 rows in the 128-byte swizzle at every width
    for i, start in ((9, heads), (13, heads + 8 * D)):
        w = W[i]
        for kb in range(w.shape[1] // 64):
            block = tiles[start + kb * 512:start + (kb + 1) * 512].view(8, 8, 8)
            r = torch.arange(8)
            for c in range(8):
                assert torch.equal(block[r, c ^ r], w[:, 64 * kb + 8 * c:64 * kb + 8 * c + 8]), \
                    (i, kb, c)


@pytest.mark.parametrize("D", [640, 1024])
def test_xwide_tile_buffer_follows_the_trunks_pass_order(D):
    """The byte counts and order of csrc/mlp_fwd_xwide_sm90.cuh's TilesX<D>:
    for each layer (w0; w1, w2, w3; w4 then w5; w6, w7, w8; w10), for each of
    its D/128 passes, the 64-column slices of the pass's 128 rows; then per
    pass w11's D/64 and w12's one slice of the pass's 64 rows (w12's 32
    columns and 32 of zeros); then the two heads of 8 rows in 64-column
    blocks. Each slice's row r holds its 16-byte chunk c at c ^ (r % 8)."""
    (tiles, _), (W, _) = _packed(D)
    P, kK = D // 128, D // 64
    full, half = 128 * 64, 64 * 64
    trunk, hidden = P * (2 + 8 * kK), P * (kK + 1)
    heads = trunk * full + hidden * half
    assert tiles.numel() == heads + 8 * D + 8 * D // 2
    r = torch.arange(128)
    swizzle = r % 8

    def holds(start, i, r0, rows, s):
        """Slice s of rows r0..r0+rows-1 of W[i] at element `start`."""
        block = tiles[start:start + rows * 64].view(rows, 8, 8)
        for c in range(8):
            col = 64 * s + 8 * c
            ref = (W[i][r0:r0 + rows, col:col + 8] if col < W[i].shape[1]
                   else torch.zeros(rows, 8, dtype=W[i].dtype))   # columns past K are zero
            assert torch.equal(block[r[:rows], c ^ swizzle[:rows]], ref), (i, r0, s, c)

    at = 0
    for layer in ((0,), (1,), (2,), (3,), (4, 5), (6,), (7,), (8,), (10,)):
        for p in range(P):
            for i in layer:
                n = -(-W[i].shape[1] // 64)
                for s in sorted({0, n - 1}):   # each weight's first and last slice of the pass
                    holds(at + s * full, i, 128 * p, 128, s)
                at += n * full
    assert at == trunk * full
    for p in range(P):
        for i in (11, 12):
            n = -(-W[i].shape[1] // 64)
            for s in sorted({0, n - 1}):
                holds(at + s * half, i, 64 * p, 64, s)
            at += n * half
    assert at == heads
    for i, start in ((9, heads), (13, heads + 8 * D)):
        w = W[i]
        for kb in range(w.shape[1] // 64):
            block = tiles[start + kb * 512:start + (kb + 1) * 512].view(8, 8, 8)
            for c in range(8):
                assert torch.equal(block[r[:8], c ^ r[:8]],
                                   w[:, 64 * kb + 8 * c:64 * kb + 8 * c + 8]), (i, kb, c)


# The gather indices of pack_tiles and pack_tiles_dx at 128 to 512, as the
# kernels there read them (SHA-256 of the little-endian int64 indices)
INDEX_DIGESTS = {128: ("2fc1a3c29da3aa19", "e63a264fd11039bc"),
                 256: ("cef8661ae5ef0dcc", "198d4e752383e948"),
                 384: ("695bb0ce723e8e52", "a90195555ae1d16d"),
                 512: ("ac50ea4ed73cfa5d", "e18ba6d6c1f3b1be")}


@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_tile_buffers_at_128_to_512_are_unchanged(D):
    """The buffers of every width the backward kernels take stay byte for byte
    what their trunks and chains read: the gather indices' digests."""
    def digest(idx):
        return hashlib.sha256(np.asarray(idx, dtype="<i8").tobytes()).hexdigest()[:16]

    assert (digest(_tile_index(D)), digest(_tile_dx_index(D))) == INDEX_DIGESTS[D]


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
