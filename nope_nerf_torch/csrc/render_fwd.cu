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
// Design: persistent CTAs, at most one per SM, each walking over the rays
// blockIdx.x, blockIdx.x + gridDim.x, ...; a ray's samples go through the MLP
// in 128-point tiles on the wgmma trunk of mlp_fwd_sm90.cuh (two consumer
// warpgroups; a producer warpgroup that streams pre-swizzled weight slices
// through a ring of shared-memory stages by cp.async.bulk and mbarriers, and
// encodes the next tile's sample positions meanwhile). The direction
// encoding is per ray, so its rgb-hidden contribution is folded into that
// layer's bias once per ray (the same fmaf order as before). The composite is
// a block-wide f32 Hillis-Steele scan over S in shared memory: the same order
// of additions as the TPU kernel's lane scan. Every output is per ray: no
// atomics, and the result is deterministic.
//
// Shared memory at D=256, S=1024, from a 1024-aligned base:
//   activations 128 x 256 bf16                        64 KB
//   position encodings, one swizzled block             16 KB
//   resident heads (8 x 256 + 8 x 128 bf16)             6 KB
//   z (S) and the raw heads (4S), f32                  20 KB
//   direction encoding, rgb-hidden bias, sums, ray      ~1 KB
//   barriers, alignment slack                          ~1.3 KB
//   weight ring: 3 stages of 32 KB                     96 KB   (-> 204 KB of 227)
// alpha and the two scan buffers (3S f32, 12 KB) reuse the activation buffer
// once the ray's last tile is done. Smaller S leaves room for more stages.
// Any S % 128 == 0 runs: above S = 3,840 at D = 256 (7,168 at D = 128) z and
// the raw heads, and above S = 5,376 (2,688) alpha and the scan buffers, go
// to the CTA's share of a scratch in device memory (mlp_fwd_sm90.cuh's
// RayPlace).

#include "mlp_fwd_sm90.cuh"

namespace {

constexpr int kSampleF32 = 5;      // z (S), raw heads (4S)
constexpr int kCompositeF32 = 3;   // alpha, scan0, scan1 (S each)

// f32 arrays beside the samples': direction encoding (32), rgb-hidden bias
// (D/2), per-warp sums (4 per warp), the ray (9, padded to 16).
template <int D>
size_t fixed_bytes() {
  return sizeof(float) * (kDe + D / 2 + 4 * kConsumerWarps + 16);
}

template <int D>
RayPlace fwd_place(int S) {
  return ray_place<D>(S, kSampleF32, kCompositeF32, fixed_bytes<D>(), kPts * D * 2);
}

// Over the consumer threads: alpha[s] from the
// raw densities hout[4s+3] and z, then the f32 exclusive Hillis-Steele prefix
// sum of log(1 - alpha + eps), ping-ponging scan0/scan1. Returns the buffer
// that holds the prefix sums; ends synchronised.
__device__ __forceinline__ float* alpha_and_prefix90(const float* hout, const float* fz,
                                                     float* alpha, float* scan0, float* scan1,
                                                     int S, int occ_softplus, int head_dist_alpha,
                                                     int dist_alpha) {
  const int tid = threadIdx.x;
  for (int s = tid; s < S; s += kConsumers) {
    const float sigma = density_act(hout[4 * s + 3], occ_softplus);
    const float occ = head_dist_alpha ? sigma : 1.f - expf(-sigma);
    float a = occ;
    if (dist_alpha) a = (s == S - 1) ? 1.f : 1.f - expf(-occ * (fz[s + 1] - fz[s]));
    alpha[s] = a;
  }
  consumer_sync();
  for (int s = tid; s < S; s += kConsumers)
    scan0[s] = s >= 1 ? logf(1.f - alpha[s - 1] + kEps) : 0.f;
  consumer_sync();
  float* src = scan0;
  float* dst = scan1;
  for (int d = 1; d < S; d <<= 1) {
    for (int s = tid; s < S; s += kConsumers) dst[s] = s >= d ? src[s] + src[s - d] : src[s];
    consumer_sync();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

template <int D>
__global__ void __launch_bounds__(kThreads90, 1)
render_fwd_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                  const unsigned char* __restrict__ tiles, Biases bias,
                  float* __restrict__ rgb_out, float* __restrict__ dist_out,
                  float* __restrict__ w_out, float* __restrict__ a_out, float* spill,
                  int n_rays, int S, int occ_softplus, int head_dist_alpha, int dist_alpha,
                  Layout90<D> L, RayPlace place) {
  using T = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = setup90(smem_raw, L.bars, L.stages);
  Ring ring = make_ring(base, L.ring, L.bars, T::kFull, L.stages);
  const uint32_t head_bar = ring.full + 16 * kMaxStages;
  const uint32_t heads = smem_addr(base + L.heads);
  const Handoff hand = make_handoff(ring);
  const int passes = S / kPts;

  if (threadIdx.x >= kConsumers) {
    set_producer_regs();
    const long long mine = (n_rays - static_cast<long long>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
    const int etid = threadIdx.x - kConsumers - 32;
    if (threadIdx.x == kConsumers) {
      produce<D>(tiles, heads, head_bar, ring, mine * passes, T::kRender);
    } else if (etid >= 0) {
      // encoders: the position encodings of the CTA's tiles in order, o + v*z
      // by explicitly rounded mul and add
      unsigned char* pe = base + L.pe;
      long long tile = 0;
      for (long long r = blockIdx.x; r < n_rays; r += gridDim.x) {
        float o[3], v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          o[c] = rays[r * 9 + c];
          v[c] = rays[r * 9 + 3 + c];
        }
        for (int p0 = 0; p0 < S; p0 += kPts, ++tile) {
          wait_free(hand.pe_free, tile);
          const float* zt = z + r * S + p0;
          encode_tile<10, kPe>(pe, etid, [&](int p, int c) {
            const float oc = c == 0 ? o[0] : (c == 1 ? o[1] : o[2]);
            const float vc = c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
            return __fadd_rn(oc, __fmul_rn(vc, zt[p]));
          });
          hand_over(hand.pe_full);
        }
      }
    }
    return;
  }
  set_consumer_regs();

  float* const f32 = reinterpret_cast<float*>(base + L.f32);
  float* const act = reinterpret_cast<float*>(base + L.act);
  const RayArrays arr = ray_arrays(place, S, f32, act, spill);
  float* fz = arr.samples;                              // z            (S)
  float* hout = fz + S;                                 // rgb raw|sig (S,4)
  float* de = arr.fixed;                                // dir encoding (32)
  float* debias = de + kDe;                             // hidden bias  (D/2)
  float* red = debias + D / 2;                          // sums         (4*warps)
  float* ray = red + 4 * kConsumerWarps;                // o | v | dir  (9)
  float* alpha = arr.composite;                         // after the MLP: alpha (S)
  float* scan0 = alpha + S;                             // scan buffers (S)
  float* scan1 = scan0 + S;
  const uint32_t pe_s = smem_addr(base + L.pe);
  const int tid = threadIdx.x;
  mbar_wait(head_bar, 0);

  long long tile = 0;
  for (long long r = blockIdx.x; r < n_rays; r += gridDim.x) {
    consumer_sync();   // the previous ray is done with every buffer
    if (tid < 9) ray[tid] = rays[r * 9 + tid];
    for (int s = tid; s < S; s += kConsumers) fz[s] = z[r * S + s];
    consumer_sync();

    // direction encoding, bf16-rounded as a matmul operand; its rgb-hidden
    // contribution is the same for every sample of the ray: debias = de @ wrde + b
    if (tid < kDe) de[tid] = __bfloat162float(__float2bfloat16_rn(dense_lane(ray + 6, tid, 4)));
    consumer_sync();
    for (int j = tid; j < D / 2; j += kConsumers) {
      float acc = 0.f;
      for (int k = 0; k < kDe; ++k) {
        const bf16 wv = *reinterpret_cast<const bf16*>(tiles + T::kW12 + swz(j, k, 0));
        acc = fmaf(de[k], __bfloat162float(wv), acc);
      }
      debias[j] = acc + bias.b[10][j];
    }
    consumer_sync();

    for (int p0 = 0; p0 < S; p0 += kPts, ++tile)
      mlp_tile90<D>(bias.b, pe_s, 0, base + L.act, heads, heads + T::kDensHead, debias,
                    hout + 4 * p0, hand, tile, ring);
    consumer_sync();   // every tile's raw heads are in

    // ---- alpha and the f32 composite ----------------------------------------
    const float* src = alpha_and_prefix90(hout, fz, alpha, scan0, scan1, S, occ_softplus,
                                          head_dist_alpha, dist_alpha);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = tid; s < S; s += kConsumers) {
      const float w = alpha[s] * expf(src[s]);
#pragma unroll
      for (int c = 0; c < 3; ++c) part[c] += w * (1.f / (1.f + expf(-hout[4 * s + c])));
      part[3] += w * fz[s];
      if (w_out != nullptr) {
        w_out[r * S + s] = w;
        a_out[r * S + s] = alpha[s];
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
    consumer_sync();
    if (tid < 4) {
      float acc = 0.f;
      for (int w = 0; w < kConsumerWarps; ++w) acc += red[4 * w + tid];
      if (tid < 3)
        rgb_out[r * 3 + tid] = acc;
      else
        dist_out[r] = acc;
    }
  }
}

// The grid: one persistent CTA per SM, at most one per ray.
inline int fwd_grid(int n_rays) {
  const int sms = sm_count();
  return n_rays < sms ? n_rays : sms;
}

template <int D>
cudaError_t launch(const float* rays, const float* z, const unsigned char* tiles,
                   const Biases& bias, float* rgb, float* dist, float* w_out, float* a_out,
                   float* spill, int n_rays, int S, int occ_softplus, int head_dist_alpha,
                   int dist_alpha, cudaStream_t stream) {
  const RayPlace place = fwd_place<D>(S);
  const size_t area = place.area(fixed_bytes<D>(), S);
  const Layout90<D> L(false, area);
  if (L.stages < 2) return cudaErrorInvalidValue;
  if (place.spill_floats(S) > 0 && spill == nullptr) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(area);
  auto* kernel = render_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = fwd_grid(n_rays);
  if (grid <= 0) return cudaErrorInvalidDevice;
  kernel<<<grid, kThreads90, smem, stream>>>(rays, z, tiles, bias, rgb, dist, w_out, a_out, spill,
                                             n_rays, S, occ_softplus, head_dist_alpha,
                                             dist_alpha, L, place);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_render.py.
// rays (n_rays, 9) f32 [origin | ray_vec | mlp_dir], z (n_rays, S) f32, all
// contiguous on the device; tiles: the weight buffer of pack_tiles (16-byte
// aligned); biases: an array of 12 device pointers in pack_weights' order; w_out/a_out may both be null. spill: the bytes
// nerf_render_fwd_spill gives (null where it gives 0). Returns a cudaError_t
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int nerf_render_fwd(const float* rays, const float* z, const void* tiles,
                               const void* const* biases, float* rgb, float* dist, float* w_out,
                               float* a_out, void* spill, int n_rays, int S, int D,
                               int occ_softplus, int head_dist_alpha, int dist_alpha,
                               void* stream) {
  if (n_rays <= 0) return 0;
  if (S <= 0 || S % kPts != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((w_out == nullptr) != (a_out == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Biases bias;
  for (int i = 0; i < 12; ++i) bias.b[i] = static_cast<const float*>(biases[i]);
  const auto* w = static_cast<const unsigned char*>(tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 256:
      err = launch<256>(rays, z, w, bias, rgb, dist, w_out, a_out, static_cast<float*>(spill),
                        n_rays, S, occ_softplus, head_dist_alpha, dist_alpha, st);
      break;
    case 128:
      err = launch<128>(rays, z, w, bias, rgb, dist, w_out, a_out, static_cast<float*>(spill),
                        n_rays, S, occ_softplus, head_dist_alpha, dist_alpha, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Bytes of nerf_render_fwd's spill scratch for n_rays x S at width D: the
// per-sample arrays that do not fit in shared memory, for each CTA of the
// grid (0 where everything fits, every S <= 1024); -1 for a width or an S
// the kernel does not take.
extern "C" long long nerf_render_fwd_spill(int n_rays, int S, int D) {
  if (S <= 0 || S % kPts != 0 || n_rays <= 0) return -1;
  long long per_cta;
  switch (D) {
    case 256:
      per_cta = fwd_place<256>(S).spill_floats(S);
      break;
    case 128:
      per_cta = fwd_place<128>(S).spill_floats(S);
      break;
    default:
      return -1;
  }
  return per_cta == 0 ? 0 : static_cast<long long>(sizeof(float)) * per_cta * fwd_grid(n_rays);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
