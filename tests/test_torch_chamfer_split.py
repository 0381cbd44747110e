"""The Chamfer sweeps split over the card (K7 and K2 in ops/chamfer.py), on the CPU.

Both kernels cut their pairs into blocks and merge per-block partials. Here:
the launch geometry that ops/chamfer.py computes covers every (src, dst) pair
exactly once, at the main path's sizes and at ragged ones (computed only;
nothing is swept at the large sizes); K7's plain version gives the same d2
and indices at every chunk length, the kernel's segment length included, with
exact duplicate dst points placed on both sides of each segment edge, where
the lower index must win; and on those duplicates the index is the JAX
package's, called on the CPU as tests/test_torch_nearest.py calls it. The SASS
reading behind chip_smoke.py's issue floors is held to a hand-written listing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nope_nerf_tpu.ops.chamfer import _nearest_idx_bidirectional as jax_bidir
from nope_nerf_tpu.ops.chamfer import nearest_dists as jax_nearest_dists

from nope_nerf_torch.ops import chamfer as C
from nope_nerf_torch.ops import nearest_dists
from nope_nerf_torch.tools import chamfer_profile as P

torch.set_num_threads(2)

SHAPES = [(1, 1), (5, 40000), (301, 77), (8192, 1), (7285, 7285), (32400, 32400),
          (47628, 47628)]


def _intervals_partition(starts_ends, n):
    """The half-open intervals, in order, tile [0, n) with none empty."""
    pos = 0
    for a, b in starts_ends:
        assert a == pos and b > a
        pos = b
    assert pos == n


@pytest.mark.parametrize("s,d", SHAPES)
def test_nearest_geometry_covers_every_pair_once(s, d):
    g = C.nearest_geometry(s, d)
    assert g.src_tile == C.NEAREST_SRC_TILE
    tiles = [(t * g.src_tile, min(s, (t + 1) * g.src_tile)) for t in range(g.src_tiles)]
    segs = [(k * g.seg_len, min(d, (k + 1) * g.seg_len)) for k in range(g.n_segs)]
    _intervals_partition(tiles, s)
    _intervals_partition(segs, d)
    # blocks are tile x segment: disjoint products of two partitions
    assert sum((b - a) * (q - p) for a, b in tiles for p, q in segs) == s * d
    assert 1 <= g.seg_len <= C.NEAREST_SEG_MAX and g.n_segs <= max(C.NEAREST_SEGS_MAX, 1)
    assert g.seg_len >= min(d, C.NEAREST_SEG_MIN)
    assert g.scratch(s) == g.n_segs * s and g.blocks == g.src_tiles * g.n_segs


@pytest.mark.parametrize("s,d", SHAPES)
def test_bidir_geometry_covers_every_pair_once(s, d):
    g = C.bidir_geometry(s, d)
    seg_len = g.sub_per_seg * g.y_tile
    tiles = [(t * g.x_tile, min(s, (t + 1) * g.x_tile)) for t in range(g.x_tiles)]
    segs = [(k * seg_len, min(d, (k + 1) * seg_len)) for k in range(g.n_segs)]
    _intervals_partition(tiles, s)
    _intervals_partition(segs, d)
    for p, q in segs:      # the sub-tiles of a segment, the last one ragged
        subs = [(u, min(q, u + g.y_tile)) for u in range(p, q, g.y_tile)]
        _intervals_partition([(a - p, b - p) for a, b in subs], q - p)
        assert len(subs) <= g.sub_per_seg
    assert sum((b - a) * (q - p) for a, b in tiles for p, q in segs) == s * d
    assert 1 <= g.sub_per_seg <= C.BIDIR_SUB_MAX
    # row partials per segment, column partials per x tile
    assert g.scratch(s, d) == g.n_segs * s + g.x_tiles * d


@pytest.mark.parametrize("s,d,blocks", [(47628, 47628, 2209), (32400, 32400, 1056),
                                        (5, 40000, 264)])
def test_nearest_grid_fills_the_card(s, d, blocks):
    """At least 2 blocks per SM on the main path's clouds, from the segments
    alone where src is small."""
    g = C.nearest_geometry(s, d)
    assert g.blocks == blocks >= 2 * C.CARD_SMS


def test_bidir_grid_at_the_train_step():
    g = C.bidir_geometry(7285, 7285)
    assert (g.x_tiles, g.sub_per_seg, g.n_segs, g.blocks) == (57, 3, 19, 1083)


def _lattice(seed, n_side, jitter=0.1):
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(*[np.arange(float(n_side))] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = base + rng.uniform(-jitter, jitter, size=base.shape)
    y = base[rng.permutation(len(base))] + rng.uniform(-jitter, jitter, size=base.shape)
    return x.astype(np.float32), y.astype(np.float32)


def _with_edge_duplicates(y, seg_len):
    """y with a copy of the point before every multiple of seg_len inserted at
    that multiple: an exact tie on both sides of each segment edge."""
    out = []
    for p in y:
        if out and len(out) % seg_len == 0:
            out.append(out[-1])
        out.append(p)
    return np.stack(out)


def _duplicate_clouds(seed, n_side):
    """A jittered lattice x and a shuffled jittered lattice y with duplicates at
    K7's segment edges for (len(x), len(y)); every x has its y within 0.35 and
    the runner-up beyond 0.65, so the only ties are the duplicates."""
    x, y0 = _lattice(seed, n_side)
    seg = C.nearest_geometry(len(x), len(y0)).seg_len
    while True:
        y = _with_edge_duplicates(y0, seg)
        again = C.nearest_geometry(len(x), len(y)).seg_len
        if again == seg:
            break
        seg = again
    edges = np.arange(seg, len(y), seg)
    assert len(edges) >= 2 and np.array_equal(y[edges], y[edges - 1])
    return x, y, seg, edges


@pytest.mark.parametrize("seed,n_side", [(0, 7), (1, 9)])
def test_plain_version_is_chunk_free_and_lowest_index_wins(seed, n_side):
    x, y, seg, edges = _duplicate_clouds(seed, n_side)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    # general clouds beside the lattice: near-ties and all
    rng = np.random.default_rng(seed + 5)
    rx = torch.from_numpy(rng.uniform(-3, 3, size=(301, 3)).astype(np.float32))
    ry = torch.from_numpy(rng.uniform(-3, 3, size=(1000, 3)).astype(np.float32))
    for src, dst in ((tx, ty), (ty, tx), (rx, ry)):
        d = dst.shape[0]
        ref = C.nearest_idx_plain(src, dst, chunk=d)
        kseg = C.nearest_geometry(src.shape[0], d).seg_len
        for chunk in sorted({1, 3, seg, kseg, 100, C.PLAIN_CHUNK, d - 1, d} - {0}):
            got = C.nearest_idx_plain(src, dst, chunk=chunk)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), chunk
    # the src point at each duplicated site takes the earlier copy
    _, idx = C.nearest_idx_plain(tx, ty, chunk=seg)
    owners = [int(np.argmin(((x - y[e]) ** 2).sum(1))) for e in edges]
    assert idx[owners].tolist() == (edges - 1).tolist()


@pytest.mark.parametrize("seed,n_side", [(2, 7), (3, 9)])
def test_duplicates_match_jax(seed, n_side):
    x, y, seg, edges = _duplicate_clouds(seed, n_side)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    j_xy, j_yx = jax_bidir(jnp.asarray(x), jnp.asarray(y), 512)
    _, i_xy = C.nearest_idx(tx, ty)
    _, i_yx = C.nearest_idx(ty, tx)
    assert np.array_equal(i_xy.numpy(), np.asarray(j_xy))
    assert np.array_equal(i_yx.numpy(), np.asarray(j_yx))
    assert set((edges - 1).tolist()) <= set(i_xy.tolist())
    assert not set(edges.tolist()) & set(i_xy.tolist())
    np.testing.assert_allclose(nearest_dists(tx, ty).numpy(),
                               np.asarray(jax_nearest_dists(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-5)


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_121chamfer_nearest_mergeEPKfPKiPfPliii
        /*0000*/                   LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
                                                                      /* 0x000fe40000000800 */
        /*0010*/                   FSETP.GEU.AND P0, PT, R2, R3, PT ;  /* 0x0000000302007208 */
        /*0020*/                   FSETP.GEU.AND P1, PT, R4, R3, PT ;  /* 0x0000000304007208 */
        /*0030*/               @P0 BRA 0x10 ;                          /* 0x0000000000000947 */
        /*0040*/                   EXIT ;                              /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_121chamfer_nearest_sweepEPKfS1_PfPiiii
        /*0000*/                   S2R R0, SR_TID.X ;                  /* 0x0000000000007919 */
        /*0010*/                   LDS.128 R4, [R2] ;                  /* 0x0000000002047984 */
        /*0020*/                   FMUL R8, R4, R10 ;                  /* 0x0000000a04087220 */
        /*0030*/                   FSETP.GEU.AND P0, PT, R8, R11, PT ; /* 0x0000000b0800720b */
        /*0040*/                   FSEL R11, R11, R8, P0 ;             /* 0x000000080b0b7208 */
        /*0050*/                   FMUL R9, R5, R10 ;                  /* 0x0000000a05097220 */
        /*0060*/                   FSETP.GEU.AND P1, PT, R9, R12, PT ; /* 0x0000000c0900720b */
        /*0070*/                   FSEL R12, R12, R9, P1 ;             /* 0x000000090c0c7208 */
        /*0080*/                   FMUL R9, R6, R10 ;                  /* 0x0000000a06097220 */
        /*0090*/                   FSETP.GEU.AND P1, PT, R9, R13, PT ; /* 0x0000000d0900720b */
        /*00a0*/                   FMUL R9, R7, R10 ;                  /* 0x0000000a07097220 */
        /*00b0*/                   FSETP.GEU.AND P1, PT, R9, R14, PT ; /* 0x0000000e0900720b */
        /*00c0*/              @!P2 BRA 0x10 ;                          /* 0x000000000000a947 */
        /*00d0*/                   IADD3 R0, R0, 0x1, RZ ;             /* 0x0000000100007810 */
        /*00e0*/               @P3 BRA 0x0 ;                           /* 0x0000000000000947 */
        /*00f0*/                   EXIT ;                              /* 0x000000000000794d */
        /*0100*/                   BRA 0x100;                          /* 0xfffffffc00fc7947 */
"""


def test_sass_hot_loop_reading():
    funcs = P.sass_functions(SASS)
    assert [len(v) for v in funcs.values()] == [5, 17]
    assert P.opcode("@!P2 FSETP.GEU.AND P1, PT, R9, R14, PT") == "FSETP"
    sweep = funcs["_ZN12_GLOBAL__N_121chamfer_nearest_sweepEPKfS1_PfPiiii"]
    # the loop 0x10..0xc0 (12 instructions, 4 compares) beats the outer 0x0..0xe0
    n, n_mark, counts = P.hot_loop(sweep, "FSETP")
    assert (n, n_mark, counts["FMUL"], counts["BRA"]) == (12, 4, 4, 1)
    assert P.hot_loop(sweep, "FMNMX") is None
    # the merge's loop has 2 compares: below the 4 a sweep's hot loop holds
    assert P.hot_loop(funcs["_ZN12_GLOBAL__N_121chamfer_nearest_mergeEPKfPKiPfPliii"],
                      "FSETP") is None
    # 11 instructions per pair at 47,628^2 pairs: 0.75 ms
    assert abs(P.issue_floor_ms(11, 47628 ** 2) - 0.7457) < 1e-3
