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
// product [x, |x|^2, 1] . [-2y, 1, |y|^2]. The caller recomputes the exact
// distance of each winner, so only near-ties (d2 equal to 2^-10) depend on
// the rounding of d2.
//
// Bound: 3 FMAs, two adds and two packed mins per pair at plain f32 rates (no
// tensor cores: K = 3), against 12 bytes per point; at the train step's
// 7,285 x 7,285 points the work is a few tens of microseconds, so the
// launch and the two small fills around it weigh as much as the sweep.
//
// Design: the grid is (x tiles of 256 rows) x (y segments of 512 points), so
// that a 7,285-point pair of clouds gives 435 blocks for 132 SMs. A block of
// 8 warps stages its y segment ([-2y | |y|^2]) in shared memory; each lane
// owns one x row and walks the segment. The row minimum is a register min,
// finished by one atomicMin per row; the column minimum of a y point over a
// warp's 32 rows is one warp-wide integer min (redux.sync), then an atomicMin
// in shared memory across the 8 warps and one in global memory per block.
// Integer min does not depend on the order of its operands, so the result is
// the same in every run. The ragged edges are masked: no padding rows.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kXTile = kThreads;     // one x row per thread
constexpr int kYSeg = 512;           // y points per block
constexpr int kIdxBits = 13;
constexpr int kIdxMask = (1 << kIdxBits) - 1;

__global__ void __launch_bounds__(kThreads)
chamfer_bidir_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     int* __restrict__ row_best, int* __restrict__ col_best, int S, int D) {
  __shared__ float4 ys[kYSeg];       // (-2y0, -2y1, -2y2, |y|^2)
  __shared__ int col_min[kYSeg];

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kYSeg;
  const int ny = min(kYSeg, D - y0);
  for (int j = tid; j < ny; j += kThreads) {
    const float a = y[3 * (y0 + j)], b = y[3 * (y0 + j) + 1], c = y[3 * (y0 + j) + 2];
    // |y|^2 summed left to right, as a sum over the last axis
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
    ys[j] = make_float4(-2.f * a, -2.f * b, -2.f * c, sq);
    col_min[j] = INT_MAX;
  }
  __syncthreads();

  const int xi = blockIdx.x * kXTile + tid;
  const bool live = xi < S;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f, xsq = 0.f;
  if (live) {
    x0 = x[3 * xi];
    x1 = x[3 * xi + 1];
    x2 = x[3 * xi + 2];
    xsq = __fadd_rn(__fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x1, x1)), __fmul_rn(x2, x2));
  }
  const int lane = tid & 31;
  int best = INT_MAX;
  for (int j = 0; j < ny; ++j) {
    const float4 yy = ys[j];          // broadcast read
    float d2 = x0 * yy.x;
    d2 = fmaf(x1, yy.y, d2);
    d2 = fmaf(x2, yy.z, d2);
    d2 = (d2 + xsq) + yy.w;
    const int key = __float_as_int(fmaxf(d2, 0.f)) & ~kIdxMask;
    best = min(best, key | (y0 + j));
    const int cand = live ? (key | xi) : INT_MAX;
    const int warp_min = __reduce_min_sync(0xffffffffu, cand);
    if (lane == 0) atomicMin(&col_min[j], warp_min);
  }
  if (live) atomicMin(&row_best[xi], best);
  __syncthreads();
  for (int j = tid; j < ny; j += kThreads) atomicMin(&col_best[y0 + j], col_min[j]);
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/chamfer.py.
// x (S,3), y (D,3) contiguous f32 on the device; row_best (S,), col_best (D,)
// int32, filled with INT_MAX by the caller; on return their low 13 bits hold
// the winning index. Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int chamfer_bidir(const float* x, const float* y, int* row_best, int* col_best,
                             int S, int D, void* stream) {
  if (S <= 0 || D <= 0 || S > (1 << kIdxBits) || D > (1 << kIdxBits))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kXTile - 1) / kXTile, (D + kYSeg - 1) / kYSeg);
  chamfer_bidir_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, row_best, col_best, S, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chamfer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
