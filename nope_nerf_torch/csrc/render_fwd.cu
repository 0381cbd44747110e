// Fused forward volume render of NeRF rays on Hopper (sm_90a).
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_render.py::_render_fwd_kernel
// (reached through _raw_render_fwd / render_rays_fused / render_rays_fused_noaux).
// Per ray it computes, without writing any per-point value to device memory:
//   positions o + v*z -> dense-lane frequency encoding [xyz | 30 sin | 30 cos | 0]
//   -> 9-layer MLP with the layer-4 skip -> density and rgb heads
//   -> alpha (occupancy, or dist_alpha with a forced last hit)
//   -> f32 composite: trans = exp(exclusive prefix sum of log(1 - a + 1e-6)).
// Outputs: rgb (N,3), dist (N,), and optionally weights and alpha (N,S).
//
// Numerics follow the TPU kernel: matmul operands are bf16 with f32
// accumulation; activations are rounded to bf16 after each ReLU, `feat` is
// rounded without one; heads, alpha and the composite stay f32. Positions are
// formed with explicitly rounded mul/add (no FMA contraction) and the encoding
// uses the accurate sinf/cosf: arguments reach 2^9 * |coord|, far outside the
// range where the fast intrinsics are accurate.
//
// Bound: the work is compute. A 188x621 frame at 128 samples is 14.94 M points
// x 1.180 MFLOP of MLP, plus the direction part of the rgb-hidden layer once
// per ray, = 17.63 TFLOP, against ~67 MB of ray and weight I/O, so the least
// time is the FLOPs over the card's dense bf16 tensor-core rate.
//
// Design (simple first, speed later): one CTA of 8 warps per ray. The ray's
// samples are processed in passes of 128 points; each pass keeps its
// activations in shared memory (two ping-pong 128 x (D+8) bf16 buffers plus
// the 128 x 72 position encoding for the skip layer) and runs every layer as
// warp-level mma.sync m16n8k16 bf16 tiles. Weights (~1.2 MB bf16 at D=256)
// are read from global memory through the read-only path and stay in L2. The
// direction encoding is per ray, so its rgb-hidden contribution is folded
// into that layer's bias once per ray. The composite is a block-wide f32
// Hillis-Steele scan over S in shared memory: the same order of additions as
// the TPU kernel's lane scan. Every output is per ray: no atomics, and the
// result is deterministic.

#include "nerf_mlp.cuh"

namespace {

constexpr int kMaxS = 1024;

template <int D>
size_t smem_bytes(int S) {
  return sizeof(bf16) * (2 * act_elems<D>() + static_cast<size_t>(kPts) * kLdPe) +
         sizeof(float) * (8 * static_cast<size_t>(S) + kDe + D / 2 + 4 * kWarps + 16);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
render_fwd_kernel(const float* __restrict__ rays, const float* __restrict__ z, Net net,
                  float* __restrict__ rgb_out, float* __restrict__ dist_out,
                  float* __restrict__ w_out, float* __restrict__ a_out, int S,
                  int occ_softplus, int head_dist_alpha, int dist_alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf_a = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf_b = buf_a + act_elems<D>();
  bf16* pe = buf_b + act_elems<D>();
  float* fz = reinterpret_cast<float*>(pe + kPts * kLdPe);  // z            (S)
  float* hout = fz + S;                                     // rgb raw|sig (S,4)
  float* alpha = hout + 4 * S;                              // alpha        (S)
  float* scan0 = alpha + S;                                 // scan buffers (S)
  float* scan1 = scan0 + S;
  float* de = scan1 + S;                                    // dir encoding (32)
  float* debias = de + kDe;                                 // hidden bias  (D/2)
  float* red = debias + D / 2;                              // reductions   (4*warps)
  float* ray = red + 4 * kWarps;                            // o | v | dir  (9)

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 9) ray[tid] = rays[static_cast<size_t>(r) * 9 + tid];
  for (int s = tid; s < S; s += kThreads) fz[s] = z[static_cast<size_t>(r) * S + s];
  __syncthreads();

  // direction encoding, bf16-rounded as a matmul operand; its rgb-hidden
  // contribution is the same for every sample of the ray
  direction_bias<D>(net, ray, de, debias);

  for (int p0 = 0; p0 < S; p0 += kPts) {
    encode_pass(pe, ray, fz + p0);
    __syncthreads();
    mlp_pass<D, false>(net, pe, buf_a, buf_b, debias, hout + 4 * p0, nullptr);
  }

  // ---- alpha and the f32 composite ------------------------------------------
  const float* src = alpha_and_prefix(hout, fz, alpha, scan0, scan1, S, occ_softplus,
                                      head_dist_alpha, dist_alpha);

  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = tid; s < S; s += kThreads) {
    const float w = alpha[s] * expf(src[s]);
#pragma unroll
    for (int c = 0; c < 3; ++c) part[c] += w * (1.f / (1.f + expf(-hout[4 * s + c])));
    part[3] += w * fz[s];
    if (w_out != nullptr) {
      w_out[static_cast<size_t>(r) * S + s] = w;
      a_out[static_cast<size_t>(r) * S + s] = alpha[s];
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) red[4 * warp + c] = part[c];
  }
  __syncthreads();
  if (tid < 4) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += red[4 * w + tid];
    if (tid < 3)
      rgb_out[static_cast<size_t>(r) * 3 + tid] = acc;
    else
      dist_out[r] = acc;
  }
}

template <int D>
cudaError_t launch(const float* rays, const float* z, const Net& net, float* rgb, float* dist,
                   float* w_out, float* a_out, int n_rays, int S, int occ_softplus,
                   int head_dist_alpha, int dist_alpha, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(S);
  cudaError_t err = cudaFuncSetAttribute(render_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  render_fwd_kernel<D><<<n_rays, kThreads, smem, stream>>>(
      rays, z, net, rgb, dist, w_out, a_out, S, occ_softplus, head_dist_alpha, dist_alpha);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py.
// rays (n_rays, 9) f32 [origin | ray_vec | mlp_dir], z (n_rays, S) f32, all
// contiguous on the device; weights/biases: arrays of 14 and 12 device
// pointers in the Net layout; w_out/a_out may both be null. Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
extern "C" int nerf_render_fwd(const float* rays, const float* z, const void* const* weights,
                               const void* const* biases, float* rgb, float* dist, float* w_out,
                               float* a_out, int n_rays, int S, int D, int occ_softplus,
                               int head_dist_alpha, int dist_alpha, void* stream) {
  if (n_rays <= 0) return 0;
  if (S <= 0 || S % kPts != 0 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  if ((w_out == nullptr) != (a_out == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  for (int i = 0; i < 14; ++i) net.w[i] = static_cast<const bf16*>(weights[i]);
  for (int i = 0; i < 12; ++i) net.b[i] = static_cast<const float*>(biases[i]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 256:
      err = launch<256>(rays, z, net, rgb, dist, w_out, a_out, n_rays, S, occ_softplus,
                        head_dist_alpha, dist_alpha, st);
      break;
    case 128:
      err = launch<128>(rays, z, net, rgb, dist, w_out, a_out, n_rays, S, occ_softplus,
                        head_dist_alpha, dist_alpha, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
