// Bidirectional nearest-neighbour sweep of the Chamfer loss on Hopper (sm_90a).
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_chamfer.py::_bidir_kernel
// (reached through nearest_idx_bidirectional_pallas) and, on this card, the XLA
// scan of nope_nerf_tpu/ops/chamfer.py::_nearest_idx_bidirectional as well.
// For clouds x (S,3) and y (D,3), S, D <= 8192, one sweep over the S x D squared
// distances gives argmin_y d(x_i, y) for every i and argmin_x d(y_j, x) for
// every j. As in the TPU kernel, min and argmin are one integer min of
//   (bits(max(d2, 0)) & ~0x1FFF) | index
// with d2 = |x|^2 + |y|^2 - 2<x,y> summed in the order of the augmented
// product [x, |x|^2, 1] . [-2y, 1, |y|^2]:
//   d2 = fma(x2, -2y2, fma(x1, -2y1, x0 * -2y0)); d2 = (d2 + |x|^2) + |y|^2.
// The caller recomputes the exact distance of each winner, so only near-ties
// (d2 equal to 2^-10) depend on the rounding of d2. Integer min does not depend
// on the order of its operands, so every layout of the sweep gives the same
// indices, in every run.
//
// Bound. FLOPs: 8 f32 operations per pair against 67 TFLOP/s: 6.3 us at the
// train step's 7,285 x 7,285 points (53.1 M pairs); bytes negligible. By issue:
// a pair costs its 6 arithmetic instructions (a product, two FMAs, two sums, the
// clamp), the mask, and per direction an index add and an integer min, which
// nvcc fuses into one VIADDMNMX: with the per-tile reductions the hot loop
// holds 10.5 instructions a pair, at 7,285^2 pairs 1.59 us each (132 SMs x 4
// warp-instructions a clock x 1.98 GHz), so about 17 us. chip_smoke.py counts the hot loop's instructions per
// pair from `cuobjdump -sass` of the build (tools/chamfer_profile.py) and
// prints that floor beside the time; tools/chamfer_profile.py times the
// kernel with other register tiles, occupancy and forms of the key.
//
// Design: the pair's own instructions and nothing else in the hot loop.
// - Register tiles. A block of 256 threads covers 128 x rows; thread (tx, ty),
//   tx = lane & 15, ty = 2 * warp + lane / 16, holds rows tx + 16 r and, per
//   sub-tile of 128 y points, columns ty + 16 c (r, c < 8): an 8 x 8 tile with
//   8 row minima and 8 column minima as packed ints in registers. x rows and
//   the block's y segment ((-2y0, -2y1, -2y2, |y|^2)) are staged once in
//   shared memory; a sub-tile reads 8 float4 per thread for its 64 pairs.
// - Reductions once per tile, not per pair. After each 128 x 128 sub-tile the
//   column minima are combined over the 16 lanes of a half-warp, which hold
//   all 128 rows of those columns, by a transposing butterfly (xor 8, 4, 2, 1:
//   8 shuffles for 8 columns) that leaves column tx / 2 in lane tx; even lanes
//   write it. Row minima stay in registers over the whole y segment and are
//   combined once per block: a shuffle across the two half-warps, then over
//   the 8 warps in shared memory. No atomics.
// - Partials, no fills. Each block writes one row partial per x row and one
//   column partial per y point into scratch the wrapper allocates (every entry
//   written, so nothing is filled); a second small launch takes the integer
//   minimum over the partials of each point, masks the index and writes it as
//   int64. Two device launches per call (sweep, finish), counted as one launch
//   of the kernel; the parent design took seven (two fills, the kernel, two
//   masks, two casts).
// - The whole card. ops/chamfer.py::bidir_geometry cuts y into segments of a
//   few sub-tiles so that the grid has about 8 blocks per SM (1,083 at
//   7,285^2: 57 x tiles x 19 segments of 3 sub-tiles).
// - The ragged edges (rows past S, columns past D) take a second copy of the
//   tile that skips dead pairs; full tiles carry no checks.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16 threads: tx = lane & 15, ty = 2 * warp + lane / 16
constexpr int kMinBlocks = 2;        // blocks per SM the registers are held to
constexpr int kR = 8;                // rows per thread
constexpr int kC = 8;                // columns per thread and sub-tile (a power of two, <= 16)
constexpr int kTileX = 16 * kR;      // x rows per block
constexpr int kTileY = 16 * kC;      // y points per sub-tile
constexpr int kSubMax = 8;           // sub-tiles per segment (16 KB of float4)
constexpr int kIdxBits = 13;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kFinishThreads = 256;

constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }
constexpr int kColShift = 4 - log2i(kC);   // lane (tx) >> kColShift: the column it ends with

// The transposing butterfly over the 16 lanes of a half-warp: on entry each
// lane holds kC column minima over its own rows; on return the minimum of
// column (lane & 15) >> kColShift over all 16 lanes. While a lane holds more
// than one value, each step (xor 8, 4, ...) halves them: it keeps the half its
// lane bit selects and sends the other half to the partner, whose bit is the
// opposite; the steps left (down to xor 1) combine the last value. For kC = 8:
// 4 + 2 + 1 + 1 = 8 shuffles for 8 columns.
__device__ __forceinline__ int halfwarp_column_min(const int (&v)[kC], int lane) {
  int cur[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) cur[i] = v[i];
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    const int mask = 8 >> step;
    const int n = kC >> step;                  // values a lane holds before this step
    if (n > 1) {
      const bool hi = lane & mask;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const int keep = hi ? cur[i + n / 2] : cur[i];
        const int send = hi ? cur[i] : cur[i + n / 2];
        cur[i] = min(keep, __shfl_xor_sync(0xffffffffu, send, mask));
      }
    } else {
      cur[0] = min(cur[0], __shfl_xor_sync(0xffffffffu, cur[0], mask));
    }
  }
  return cur[0];
}

// A sub-tile's column minima over the block's rows: column ybase + 16 c of
// this thread's half-warp, c = (lane & 15) >> kColShift, written by the first
// lane of the ones that hold it.
__device__ __forceinline__ void write_columns(const int (&cmin)[kC], int lane, int ybase, int D,
                                              int* __restrict__ col_row) {
  const int col = halfwarp_column_min(cmin, lane);
  const int yj = ybase + 16 * ((lane & 15) >> kColShift);
  if (!(lane & ((1 << kColShift) - 1)) && yj < D) col_row[yj] = col;
}

// One kTileX x kTileY sub-tile. EDGE: some rows or columns lie past the clouds and
// their pairs are skipped; otherwise no check per pair.
template <bool EDGE>
__device__ __forceinline__ void sweep_tile(const float4 (&xr)[kR], const int (&xi)[kR],
                                           const float4* __restrict__ ys, int ybase,
                                           int S, int D, int (&rmin)[kR], int (&cmin)[kC]) {
  float4 yv[kC];
  int yi[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    yv[c] = ys[16 * c];
    yi[c] = ybase + 16 * c;
    cmin[c] = INT_MAX;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (EDGE && (xi[r] >= S || yi[c] >= D)) continue;
      float d2 = __fmul_rn(xr[r].x, yv[c].x);
      d2 = fmaf(xr[r].y, yv[c].y, d2);
      d2 = fmaf(xr[r].z, yv[c].z, d2);
      d2 = __fadd_rn(__fadd_rn(d2, xr[r].w), yv[c].w);
      // the masked key's low bits are clear, so + is |: one mask and two adds,
      // which ran faster than the ORs (tools/chamfer_profile.py, variant `or`)
      const int key = __float_as_int(fmaxf(d2, 0.f)) & ~kIdxMask;
      rmin[r] = min(rmin[r], key + yi[c]);
      cmin[c] = min(cmin[c], key + xi[r]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
chamfer_bidir_sweep(const float* __restrict__ x, const float* __restrict__ y,
                    int* __restrict__ row_part, int* __restrict__ col_part,
                    int S, int D, int sub_per_seg) {
  __shared__ float4 xs[kTileX];                  // (x0, x1, x2, |x|^2)
  __shared__ float4 ys[kSubMax * kTileY];        // (-2y0, -2y1, -2y2, |y|^2)
  __shared__ int red[kThreads / 32][kTileX];     // row minima per warp

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = lane & 15, ty = 2 * warp + (lane >> 4);
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * sub_per_seg * kTileY;
  const int ny = min(sub_per_seg * kTileY, D - y0);
  const int nx = min(kTileX, S - x0);

  for (int i = tid; i < nx; i += kThreads) {
    const float a = x[3 * (x0 + i)], b = x[3 * (x0 + i) + 1], c = x[3 * (x0 + i) + 2];
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
    xs[i] = make_float4(a, b, c, sq);
  }
  for (int j = tid; j < ny; j += kThreads) {
    const float a = y[3 * (y0 + j)], b = y[3 * (y0 + j) + 1], c = y[3 * (y0 + j) + 2];
    // |y|^2 summed left to right, as a sum over the last axis
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
    ys[j] = make_float4(-2.f * a, -2.f * b, -2.f * c, sq);
  }
  __syncthreads();

  float4 xr[kR];
  int xi[kR], rmin[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    xr[r] = xs[tx + 16 * r];                     // rows past S: read, never used
    xi[r] = x0 + tx + 16 * r;
    rmin[r] = INT_MAX;
  }

  // the full sub-tiles first, in a loop of their own (the hot loop), then the
  // ragged ones; after each, its column minima go out
  const int n_sub = (ny + kTileY - 1) / kTileY;
  const int n_full = nx == kTileX ? ny / kTileY : 0;
  int* const col_row = col_part + static_cast<int64_t>(blockIdx.x) * D;
  int cmin[kC];
  int t = 0;
  for (; t < n_full; ++t) {
    const int ybase = y0 + t * kTileY + ty;
    sweep_tile<false>(xr, xi, ys + t * kTileY + ty, ybase, S, D, rmin, cmin);
    write_columns(cmin, lane, ybase, D, col_row);
  }
  for (; t < n_sub; ++t) {
    const int ybase = y0 + t * kTileY + ty;
    sweep_tile<true>(xr, xi, ys + t * kTileY + ty, ybase, S, D, rmin, cmin);
    write_columns(cmin, lane, ybase, D, col_row);
  }

  // rows: the two half-warps of a warp hold the other columns' minima of each
  // row; then the 8 warps, through shared memory
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int v = min(rmin[r], __shfl_xor_sync(0xffffffffu, rmin[r], 16));
    if (lane < 16) red[warp][tx + 16 * r] = v;
  }
  __syncthreads();
  if (tid < nx) {
    int m = red[0][tid];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = min(m, red[w][tid]);
    row_part[static_cast<int64_t>(blockIdx.y) * S + x0 + tid] = m;
  }
}

// Point k < S: row k's minimum over the n_segs row partials; k >= S: column
// k - S's over the n_xtiles column partials. The winning index, as int64.
__global__ void __launch_bounds__(kFinishThreads)
chamfer_bidir_finish(const int* __restrict__ row_part, const int* __restrict__ col_part,
                     int64_t* __restrict__ out, int S, int D, int n_segs, int n_xtiles) {
  const int k = blockIdx.x * kFinishThreads + threadIdx.x;
  if (k >= S + D) return;
  const int* p = k < S ? row_part + k : col_part + (k - S);
  const int n = k < S ? n_segs : n_xtiles;
  const int64_t stride = k < S ? S : D;
  int m = INT_MAX;
#pragma unroll 8
  for (int g = 0; g < n; ++g) m = min(m, p[g * stride]);
  out[k] = m & kIdxMask;
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/chamfer.py.
// x (S,3), y (D,3) contiguous f32 on the device. scratch holds n_segs x S row
// partials then n_xtiles x D column partials (int32), written whole before
// they are read; out (S + D,) int64 receives argmin_y for each x, then argmin_x
// for each y. tile_x, tile_y and sub_per_seg are ops/chamfer.py::
// bidir_geometry's and are checked against this file's tiles and the cloud
// sizes. Two launches
// (sweep, finish), asynchronous on `stream`. Returns a cudaError_t (0 on
// success).
extern "C" int chamfer_bidir(const float* x, const float* y, int* scratch, int64_t* out,
                             int S, int D, int tile_x, int tile_y, int sub_per_seg,
                             void* stream) {
  if (S <= 0 || D <= 0 || S > (1 << kIdxBits) || D > (1 << kIdxBits) || tile_x != kTileX ||
      tile_y != kTileY || sub_per_seg <= 0 || sub_per_seg > kSubMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_xtiles = (S + kTileX - 1) / kTileX;
  const int n_segs = (D + sub_per_seg * kTileY - 1) / (sub_per_seg * kTileY);
  int* row_part = scratch;
  int* col_part = scratch + static_cast<int64_t>(n_segs) * S;
  chamfer_bidir_sweep<<<dim3(n_xtiles, n_segs), kThreads, 0, s>>>(x, y, row_part, col_part, S,
                                                                  D, sub_per_seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chamfer_bidir_finish<<<(S + D + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0, s>>>(
      row_part, col_part, out, S, D, n_segs, n_xtiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chamfer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
