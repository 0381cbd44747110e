// Point-query NeRF MLP forward on Hopper (sm_90a).
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_mlp.py::_fwd_kernel (reached
// through _raw_forward / nerf_apply_fused, the MLP query of the unfused render:
// the coarse and fine passes of hierarchical sampling, and any sample count the
// fused render does not take). For M points and M directions (f32, (M, 3) each)
// it computes, without writing any per-point intermediate to device memory:
//   dense-lane frequency encodings [xyz | 30 sin | 30 cos | 0] of the point and
//   [xyz | 12 sin | 12 cos | 0] of the direction, rounded to bf16
//   -> 9-layer MLP with the layer-4 skip -> density and rgb heads
//   -> softplus or relu density, 1 - exp(-sigma) unless the head's dist_alpha
//      is set, sigmoid rgb.
// Outputs: rgb (M, 3) and density (M, 1), f32.
//
// Numerics follow the TPU kernel: bf16 matmul operands with f32 accumulation,
// activations rounded to bf16 after each ReLU, `feat` rounded without one,
// heads f32. Where the TPU kernel takes (M, 64) and (M, 32) padded encodings
// from device memory and writes (M, 128) padded head outputs, this kernel
// encodes each pass from the (M, 3) inputs in shared memory and writes only
// the 4 live outputs per point; it masks its own ragged last pass, so M needs
// no padding.
//
// Bound: compute. A point is 593,408 multiply-adds (the 63 and 27 live
// encoding lanes counted), 1.187 MFLOP, against 40 bytes of input and output
// and 1.2 MB of weights per launch: at the main path's 131,072 and 196,608
// points the least time is the FLOPs over the card's dense bf16 rate.
//
// Design (simple first, speed later): the render-forward kernel's pass
// (nerf_mlp.cuh) over 128 consecutive points instead of a ray's samples: one
// CTA of 8 warps per pass, grid-striding over the passes; every layer as
// warp-level mma.sync m16n8k16 bf16 tiles on two ping-pong 128 x (D+8)
// activation buffers in shared memory; weights read through the read-only
// path and kept in L2. The direction encoding is per point here, so the
// rgb-hidden layer takes it as a second (128 x 32) x (32 x D/2) product.

#include "point_mlp.cuh"

namespace {

template <int D>
size_t fwd_smem_bytes() {
  return sizeof(bf16) * (2 * act_elems<D>() + static_cast<size_t>(kPts) * (kLdPe + kLdDe)) +
         sizeof(float) * static_cast<size_t>(kPts) * (4 + 3 + 3);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
point_mlp_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, Net net,
                     float* __restrict__ rgb, float* __restrict__ density, long long M,
                     int occ_softplus, int head_dist_alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf_a = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf_b = buf_a + act_elems<D>();
  bf16* pe = buf_b + act_elems<D>();                       // (128, 72)
  bf16* de = pe + kPts * kLdPe;                            // (128, 40)
  float* hout = reinterpret_cast<float*>(de + kPts * kLdDe);  // rgb raw | sigma raw (128, 4)
  float* xs = hout + 4 * kPts;                             // points      (128, 3)
  float* ds = xs + 3 * kPts;                               // directions  (128, 3)

  const long long n_pass = (M + kPts - 1) / kPts;
  for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x) {
    const long long p0 = pass * kPts;
    const int n = static_cast<int>(M - p0 < kPts ? M - p0 : kPts);
    load_points(xs, ds, pts, dirs, p0, n);
    __syncthreads();
    encode_points(pe, kLdPe, de, xs, ds);
    __syncthreads();
    point_mlp_pass<D, false>(net, pe, de, buf_a, buf_b, hout, nullptr);
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const float sigma = density_act(hout[4 * p + 3], occ_softplus);
      density[p0 + p] = head_dist_alpha ? sigma : 1.f - expf(-sigma);
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[3 * (p0 + p) + c] = 1.f / (1.f + expf(-hout[4 * p + c]));
    }
    __syncthreads();
  }
}

template <int D>
cudaError_t launch_fwd(const float* pts, const float* dirs, const Net& net, float* rgb,
                       float* density, long long M, int occ_softplus, int head_dist_alpha,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(point_mlp_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_pass = (M + kPts - 1) / kPts;
  const int grid = static_cast<int>(n_pass < (1 << 20) ? n_pass : (1 << 20));
  point_mlp_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(pts, dirs, net, rgb, density, M,
                                                            occ_softplus, head_dist_alpha);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_mlp.py.
// pts, dirs (M, 3) f32 contiguous on the device; weights/biases: arrays of 14
// and 12 device pointers in the Net layout (nerf_mlp.cuh); rgb (M, 3) and
// density (M, 1) f32 (out). Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int nerf_point_mlp_fwd(const float* pts, const float* dirs, const void* const* weights,
                                  const void* const* biases, float* rgb, float* density,
                                  long long M, int D, int occ_softplus, int head_dist_alpha,
                                  void* stream) {
  if (M <= 0) return 0;
  Net net;
  for (int i = 0; i < 14; ++i) net.w[i] = static_cast<const bf16*>(weights[i]);
  for (int i = 0; i < 12; ++i) net.b[i] = static_cast<const float*>(biases[i]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 256:
      err = launch_fwd<256>(pts, dirs, net, rgb, density, M, occ_softplus, head_dist_alpha, st);
      break;
    case 128:
      err = launch_fwd<128>(pts, dirs, net, rgb, density, M, occ_softplus, head_dist_alpha, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
