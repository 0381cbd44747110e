// One-direction nearest-neighbour sweep of the Chamfer loss on Hopper (sm_90a).
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_chamfer.py::_kernel (reached
// through _nearest_idx and nearest_dists_pallas) and, on this card, the
// three-reduction XLA scan that nope_nerf_tpu/ops/chamfer.py runs for clouds
// above 8,192 points. For every src point (S,3) it finds the running minimum of
//   d2 = (|x|^2 + |y|^2) - 2 <x,y>
// over every dst point (D,3), in f32 and not clamped, and its argmin; on equal
// d2 the lowest index wins (a strict < over dst in order). The index is a
// separate integer, not packed beside d2's bits as in K2 (chamfer_bidir.cu), so
// the cloud size has no cap below 2^31.
//
// Every product and sum of d2 is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: nvcc contracts none of them into an FMA), in the order of the plain
// version ops/chamfer.py::nearest_idx_plain:
//   xsq = (x0*x0 + x1*x1) + x2*x2, ysq likewise, dot = (x0*y0 + x1*y1) + x2*y2,
//   d2 = (xsq + ysq) - 2*dot.
// So d2, and with it the argmin, is bit-equal to the plain version's.
//
// Bound. FLOPs: 8 f32 operations per pair (3 products, 2 sums for the dot, 2
// for d2, the compare) against 67 TFLOP/s: 0.271 ms at the 47,628 x 47,628
// clouds of the LLFF configs (2.27 G pairs), bytes negligible (1.5 MB). That
// peak counts an FMA as two operations, and none of these rounded operations
// fuse, so the least time for this arithmetic is set by instruction issue:
// 132 SMs x 4 warp-instructions a clock x 1.98 GHz = 1.045e12 a second, which
// at 47,628^2 pairs is 0.068 ms per SASS instruction per pair. The pair costs
// 8 arithmetic instructions, one compare and two selects (d2 and index): the
// issue floor is about 11 x 0.068 = 0.75 ms. chip_smoke.py counts the
// instructions per pair of the hot loop from `cuobjdump -sass` of the build
// (tools/chamfer_profile.py) and prints the floor beside the time.
//
// Design: what the issue floor asks for is that nothing but the pair's own
// instructions issue, on every scheduler of every SM.
// - Several src points per thread. A thread holds kRows = 8 src points in
//   registers (x0, x1, x2, |x|^2, best d2, best index each); every dst point
//   it reads from shared memory (one float4 broadcast: y0, y1, y2, |y|^2)
//   serves 8 pairs, so the load and the index step cost 1/8 instruction per
//   pair. A block of 128 threads covers a src tile of 1,024 points (row r of
//   thread t is point r * 128 + t: coalesced loads and stores).
// - dst split into segments across blockIdx.y. Each block stages its segment
//   once in dynamic shared memory (16 B a point) and sweeps it in order.
//   ops/chamfer.py::nearest_geometry picks the segment length, at most 1,024
//   points, so that the grid has about 8 blocks per SM (2,209 blocks at
//   47,628^2, 1,056 at 32,400^2) and at least 2 per SM where the src cloud
//   is small (264 at 5 x 40,000, where only the segments give blocks). At 72
//   registers a thread, 7 blocks of 4 warps fit on an SM, each warp with 8
//   independent chains; the carveout asks for the whole of shared memory.
// - A deterministic merge in segment order. Each block writes its segment's
//   (d2, index) per src point to scratch the wrapper allocates (partials of
//   n_segs x S, every entry written, so no fill). A second small launch,
//   one thread per src point, walks the segments in order with the same
//   strict <: the earlier segment keeps an exact tie. That is
//   nearest_idx_plain's rule across its chunks, so the lowest index still
//   wins, and the result does not depend on the order the blocks ran in. No
//   atomics. The merge writes the index as int64, so the wrapper launches
//   nothing else: two device launches per call (sweep and merge), counted as
//   one launch of the kernel.
// A thread whose first src point lies past S has no live row: it stages its
// share of the segment and leaves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;              // threads per sweep block
constexpr int kRows = 8;                   // src points per thread
constexpr int kSrcTile = kThreads * kRows; // src points per sweep block
constexpr int kSegMax = 2048;              // dst points per segment, at most (32 KB of float4)
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

__global__ void __launch_bounds__(kThreads)
chamfer_nearest_sweep(const float* __restrict__ src, const float* __restrict__ dst,
                      float* __restrict__ part_d2, int* __restrict__ part_idx,
                      int S, int D, int seg_len) {
  extern __shared__ float4 seg[];          // (y0, y1, y2, |y|^2), seg_len entries

  const int tid = threadIdx.x;
  const int j0 = blockIdx.y * seg_len;
  const int n = min(seg_len, D - j0);
  for (int j = tid; j < n; j += kThreads) {
    const int64_t k = 3 * static_cast<int64_t>(j0 + j);
    const float a = dst[k], b = dst[k + 1], c = dst[k + 2];
    seg[j] = make_float4(a, b, c, sq3(a, b, c));
  }

  const int i0 = blockIdx.x * kSrcTile + tid;
  float x0[kRows], x1[kRows], x2[kRows], xsq[kRows], best[kRows];
  int best_j[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kThreads;
    x0[r] = x1[r] = x2[r] = 0.f;
    if (i < S) {
      x0[r] = src[3 * static_cast<int64_t>(i)];
      x1[r] = src[3 * static_cast<int64_t>(i) + 1];
      x2[r] = src[3 * static_cast<int64_t>(i) + 2];
    }
    xsq[r] = sq3(x0[r], x1[r], x2[r]);
    best[r] = __int_as_float(0x7f800000);  // +inf: the first finite d2 wins
    best_j[r] = 0;
  }
  __syncthreads();
  if (i0 >= S) return;                     // no live row: rows r > 0 lie further on

#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 y = seg[j];               // broadcast: every thread reads entry j
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(x0[r], y.x), __fmul_rn(x1[r], y.y)),
                                  __fmul_rn(x2[r], y.z));
      const float d2 = __fsub_rn(__fadd_rn(xsq[r], y.w), __fmul_rn(2.f, dot));
      if (d2 < best[r]) {
        best[r] = d2;
        best_j[r] = j;
      }
    }
  }

  const int64_t base = static_cast<int64_t>(blockIdx.y) * S;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kThreads;
    if (i < S) {
      part_d2[base + i] = best[r];
      part_idx[base + i] = j0 + best_j[r];
    }
  }
}

// Segment order, strict <: the earlier segment keeps an exact tie. A segment
// whose every d2 was +inf (or NaN) left +inf, which never replaces the running
// +inf, so such a src point gets index 0 and d2 +inf, as in the plain version.
__global__ void __launch_bounds__(kMergeThreads)
chamfer_nearest_merge(const float* __restrict__ part_d2, const int* __restrict__ part_idx,
                      float* __restrict__ d2_out, int64_t* __restrict__ idx_out,
                      int S, int n_segs) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= S) return;
  float best = __int_as_float(0x7f800000);
  int best_j = 0;
#pragma unroll 8
  for (int g = 0; g < n_segs; ++g) {
    const int64_t k = static_cast<int64_t>(g) * S + i;
    const float d = part_d2[k];
    const int j = part_idx[k];
    if (d < best) {
      best = d;
      best_j = j;
    }
  }
  d2_out[i] = best;
  idx_out[i] = best_j;
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/chamfer.py.
// src (S,3), dst (D,3): contiguous f32 on the device. part_d2 (n_segs, S) f32
// and part_idx (n_segs, S) int32 are scratch, written whole before they are
// read; d2 (S,) f32 and idx (S,) int64 are written whole. src_tile, seg_len and
// n_segs are ops/chamfer.py::nearest_geometry's; they are checked against this
// file's tile and the cloud sizes. Two launches (sweep, merge), asynchronous on
// `stream`. Returns a cudaError_t (0 on success).
extern "C" int chamfer_nearest(const float* src, const float* dst, float* part_d2,
                               int* part_idx, float* d2, int64_t* idx, int S, int D,
                               int src_tile, int seg_len, int n_segs, void* stream) {
  if (S <= 0 || D <= 0 || src_tile != kSrcTile || seg_len <= 0 || seg_len > kSegMax ||
      n_segs != (D + seg_len - 1) / seg_len || n_segs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // all of the SM's 228 KB as shared memory: without it the CUDA runtime may
  // set aside too little for the blocks the registers allow
  static const cudaError_t carveout = cudaFuncSetAttribute(
      chamfer_nearest_sweep, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  const dim3 grid((S + kSrcTile - 1) / kSrcTile, n_segs);
  chamfer_nearest_sweep<<<grid, kThreads, seg_len * sizeof(float4), s>>>(
      src, dst, part_d2, part_idx, S, D, seg_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chamfer_nearest_merge<<<(S + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(
      part_d2, part_idx, d2, idx, S, n_segs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chamfer_nearest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
