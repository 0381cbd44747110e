// One-direction nearest-neighbour sweep of the Chamfer loss on Hopper (sm_90a).
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_chamfer.py::_kernel (reached
// through _nearest_idx and nearest_dists_pallas) and, on this card, the
// three-reduction XLA scan that nope_nerf_tpu/ops/chamfer.py runs for clouds
// above 8,192 points. For every src point (S,3) it finds the running minimum of
//   d2 = (|x|^2 + |y|^2) - 2 <x,y>
// over every dst point (D,3), in f32 and not clamped, and its argmin as int32;
// on equal d2 the lowest index wins (a strict < over dst in order). The index is
// a separate int32, not packed beside d2's bits as in K2 (chamfer_bidir.cu), so
// the cloud size has no cap below 2^31.
//
// Every product and sum of d2 is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: nvcc contracts none of them into an FMA), in the order of the plain
// version ops/chamfer.py::nearest_idx_plain:
//   xsq = (x0*x0 + x1*x1) + x2*x2, ysq likewise, dot = (x0*y0 + x1*y1) + x2*y2,
//   d2 = (xsq + ysq) - 2*dot.
// So d2, and with it the argmin, is bit-equal to the plain version's.
//
// Bound: about 8 f32 operations per pair outside the tensor cores (3 products,
// 2 sums for the dot, 2 for d2, the compare), against 12 bytes in and 8 out per
// point: at the 47,628 x 47,628 clouds of the LLFF configs 2.27 G pairs, 0.27 ms
// at the f32 rate, operations-bound by four orders of magnitude.
//
// Design (simple first): one thread per src point in blocks of 256; dst staged
// through shared memory in tiles of 1,024 points as float4 (y0, y1, y2, |y|^2),
// 16 KB a tile, every thread of the block reading the same entry (a broadcast).
// A cloud of 47,628 points is 762 KB and does not fit in a block's 227 KB, so the
// block walks the tiles in order. No atomics: each thread owns its src point's
// minimum. The ragged last src block keeps its idle threads for the staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // src points per block, one per thread
constexpr int kTile = 1024;       // dst points per shared-memory tile

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

__global__ void __launch_bounds__(kThreads)
chamfer_nearest_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                       float* __restrict__ d2_out, int* __restrict__ idx_out, int S, int D) {
  __shared__ float4 tile[kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < S;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (live) {
    x0 = src[3 * static_cast<int64_t>(i)];
    x1 = src[3 * static_cast<int64_t>(i) + 1];
    x2 = src[3 * static_cast<int64_t>(i) + 2];
  }
  const float xsq = sq3(x0, x1, x2);
  float best = __int_as_float(0x7f800000);   // +inf: the first finite d2 wins
  int best_j = 0;

  for (int t0 = 0; t0 < D; t0 += kTile) {
    const int n = min(kTile, D - t0);
    __syncthreads();                          // the previous tile is read out
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int64_t k = 3 * static_cast<int64_t>(t0 + j);
      const float a = dst[k], b = dst[k + 1], c = dst[k + 2];
      tile[j] = make_float4(a, b, c, sq3(a, b, c));
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 y = tile[j];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(x0, y.x), __fmul_rn(x1, y.y)),
                                  __fmul_rn(x2, y.z));
      const float d2 = __fsub_rn(__fadd_rn(xsq, y.w), __fmul_rn(2.f, dot));
      if (d2 < best) {
        best = d2;
        best_j = t0 + j;
      }
    }
  }
  if (live) {
    d2_out[i] = best;
    idx_out[i] = best_j;
  }
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/chamfer.py.
// src (S,3), dst (D,3): contiguous f32 on the device; d2 (S,) f32 and idx (S,)
// int32 are written whole. Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int chamfer_nearest(const float* src, const float* dst, float* d2, int* idx,
                               int S, int D, void* stream) {
  if (S <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kThreads - 1) / kThreads);
  chamfer_nearest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, dst, d2, idx, S, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chamfer_nearest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
