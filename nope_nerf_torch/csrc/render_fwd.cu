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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPts = 128;               // points per pass: 8 m-tiles of 16 rows
constexpr int kPe = 64;                 // position encoding lanes (63 live)
constexpr int kDe = 32;                 // direction encoding lanes (27 live)
constexpr int kPad = 8;                 // bf16 row pad: conflict-free fragment loads
constexpr int kLdPe = kPe + kPad;
constexpr int kMaxS = 1024;
constexpr float kEps = 1e-6f;           // compositing epsilon (reference rendering.py:9)

static_assert(kWarps * 16 == kPts, "one m-tile of 16 rows per warp in the heads");

// Packed network, the layout of nope_nerf_torch.ops.fused_render.pack_weights.
// Every weight is stored (out, in) row-major in bf16:
//   w[0] trunk0_0 (D,64)   w[1..3] trunk0_1..3 (D,D)   w[4] trunk1_0 x-part (D,D)
//   w[5] trunk1_0 pe-part (D,64)   w[6..8] trunk1_1..3 (D,D)   w[9] density (8,D)
//   w[10] feature (D,D)   w[11] rgb_hidden x-part (D/2,D)
//   w[12] rgb_hidden dir-part (D/2,32)   w[13] rgb (8,D/2)
// Biases are f32: b[0..3] trunk0, b[4..7] trunk1, b[8] density (8), b[9] feature,
// b[10] rgb_hidden (D/2), b[11] rgb (8). Head rows/biases beyond the live ones are 0.
struct Net {
  const bf16* w[14];
  const float* b[12];
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j] += X[m0+16i : +16, 0:K] @ W[n0+8j : +8, 0:K]^T for one warp.
// X lives in shared memory (row stride ldx), W (N,K) in global memory.
template <int K, int BM, int BN>
__device__ __forceinline__ void mma_tile(float (&acc)[BM][BN][4], const bf16* x, int ldx,
                                         const bf16* __restrict__ w, int m0, int n0,
                                         int g, int t) {
  static_assert(K % 16 == 0, "K must be a multiple of 16");
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[BN][2];
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(
          w + static_cast<size_t>(n0 + 8 * j + g) * K + k0 + 2 * t);
      b[j][0] = __ldg(wp);
      b[j][1] = __ldg(wp + 4);  // k + 8
    }
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const bf16* xp = x + (m0 + 16 * i + g) * ldx + k0 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(xp);
      a[1] = *reinterpret_cast<const uint32_t*>(xp + 8 * ldx);
      a[2] = *reinterpret_cast<const uint32_t*>(xp + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(xp + 8 * ldx + 8);
#pragma unroll
      for (int j = 0; j < BN; ++j) mma_bf16_16816(acc[i][j], a, b[j][0], b[j][1]);
    }
  }
}

// y = act(x1 @ w1^T + [x2 @ w2^T] + bias) for the pass's 128 rows, rounded to
// bf16 into shared memory. Warps take 64x32 output blocks in turn.
template <int K1, int K2, int N, bool RELU>
__device__ __forceinline__ void dense(const bf16* x1, int ld1, const bf16* __restrict__ w1,
                                      const bf16* x2, int ld2, const bf16* __restrict__ w2,
                                      const float* bias, bf16* y, int ldy) {
  constexpr int BM = 4, BN = 4;
  constexpr int MB = kPts / (16 * BM);
  constexpr int NB = N / (8 * BN);
  static_assert(N % (8 * BN) == 0, "N must be a multiple of 32");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int blk = warp; blk < MB * NB; blk += kWarps) {
    const int m0 = (blk % MB) * 16 * BM;
    const int n0 = (blk / MB) * 8 * BN;
    float acc[BM][BN][4];
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float c0 = bias[n0 + 8 * j + 2 * t], c1 = bias[n0 + 8 * j + 2 * t + 1];
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        acc[i][j][0] = c0;
        acc[i][j][1] = c1;
        acc[i][j][2] = c0;
        acc[i][j][3] = c1;
      }
    }
    mma_tile<K1, BM, BN>(acc, x1, ld1, w1, m0, n0, g, t);
    if constexpr (K2 > 0) mma_tile<K2, BM, BN>(acc, x2, ld2, w2, m0, n0, g, t);
#pragma unroll
    for (int i = 0; i < BM; ++i) {
#pragma unroll
      for (int j = 0; j < BN; ++j) {
        float v0 = acc[i][j][0], v1 = acc[i][j][1], v2 = acc[i][j][2], v3 = acc[i][j][3];
        if (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
          v2 = fmaxf(v2, 0.f);
          v3 = fmaxf(v3, 0.f);
        }
        const int row = m0 + 16 * i + g, col = n0 + 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(y + row * ldy + col) = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(y + (row + 8) * ldy + col) =
            __floats2bfloat162_rn(v2, v3);
      }
    }
  }
}

// f32 head: out[row*4 + col_off + c] = (x @ w^T + bias)[row, c] for c < ncols.
template <int K>
__device__ __forceinline__ void head(const bf16* x, int ldx, const bf16* __restrict__ w,
                                     const float* __restrict__ bias, float* out, int col_off,
                                     int ncols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp;
  float acc[1][1][4];
  acc[0][0][0] = bias[2 * t];
  acc[0][0][1] = bias[2 * t + 1];
  acc[0][0][2] = acc[0][0][0];
  acc[0][0][3] = acc[0][0][1];
  mma_tile<K, 1, 1>(acc, x, ldx, w, m0, 0, g, t);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 2 * t + h;
    if (c < ncols) {
      out[(m0 + g) * 4 + col_off + c] = acc[0][0][h];
      out[(m0 + g + 8) * 4 + col_off + c] = acc[0][0][2 + h];
    }
  }
}

// Dense-lane frequency encoding of a 3-vector: [x | sin(2^i x_c) | cos(2^i x_c) | 0],
// lane 3 + 3i + c in the sin block, 3 + 3L + 3i + c in the cos block.
__device__ __forceinline__ float dense_lane(const float* x, int lane, int levels) {
  if (lane < 3) return x[lane];
  int q = lane - 3;
  const bool is_sin = q < 3 * levels;
  if (!is_sin) q -= 3 * levels;
  if (q >= 3 * levels) return 0.f;
  const float a = x[q % 3] * static_cast<float>(1 << (q / 3));  // exact scaling
  return is_sin ? sinf(a) : cosf(a);
}

template <int D>
__host__ __device__ constexpr size_t act_elems() { return static_cast<size_t>(kPts) * (D + kPad); }

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
  constexpr int ldx = D + kPad;
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
  if (tid < kDe) de[tid] = __bfloat162float(__float2bfloat16_rn(dense_lane(ray + 6, tid, 4)));
  __syncthreads();
  for (int j = tid; j < D / 2; j += kThreads) {
    const bf16* wr = net.w[12] + static_cast<size_t>(j) * kDe;
    float acc = 0.f;
    for (int k = 0; k < kDe; ++k) acc = fmaf(de[k], __bfloat162float(wr[k]), acc);
    debias[j] = acc + net.b[10][j];
  }

  for (int p0 = 0; p0 < S; p0 += kPts) {
    for (int e = tid; e < kPts * kPe; e += kThreads) {
      const int p = e / kPe, k = e % kPe;
      const float zz = fz[p0 + p];
      float pts[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) pts[c] = __fadd_rn(ray[c], __fmul_rn(ray[3 + c], zz));
      pe[p * kLdPe + k] = __float2bfloat16_rn(dense_lane(pts, k, 10));
    }
    __syncthreads();
    dense<kPe, 0, D, true>(pe, kLdPe, net.w[0], nullptr, 0, nullptr, net.b[0], buf_a, ldx);
    __syncthreads();
    dense<D, 0, D, true>(buf_a, ldx, net.w[1], nullptr, 0, nullptr, net.b[1], buf_b, ldx);
    __syncthreads();
    dense<D, 0, D, true>(buf_b, ldx, net.w[2], nullptr, 0, nullptr, net.b[2], buf_a, ldx);
    __syncthreads();
    dense<D, 0, D, true>(buf_a, ldx, net.w[3], nullptr, 0, nullptr, net.b[3], buf_b, ldx);
    __syncthreads();
    dense<D, kPe, D, true>(buf_b, ldx, net.w[4], pe, kLdPe, net.w[5], net.b[4], buf_a, ldx);
    __syncthreads();
    dense<D, 0, D, true>(buf_a, ldx, net.w[6], nullptr, 0, nullptr, net.b[5], buf_b, ldx);
    __syncthreads();
    dense<D, 0, D, true>(buf_b, ldx, net.w[7], nullptr, 0, nullptr, net.b[6], buf_a, ldx);
    __syncthreads();
    dense<D, 0, D, true>(buf_a, ldx, net.w[8], nullptr, 0, nullptr, net.b[7], buf_b, ldx);
    __syncthreads();
    // x7 is in buf_b: density head (raw, f32) and feat (bf16, no ReLU)
    head<D>(buf_b, ldx, net.w[9], net.b[8], hout + 4 * p0, 3, 1);
    dense<D, 0, D, false>(buf_b, ldx, net.w[10], nullptr, 0, nullptr, net.b[9], buf_a, ldx);
    __syncthreads();
    dense<D, 0, D / 2, true>(buf_a, ldx, net.w[11], nullptr, 0, nullptr, debias, buf_b, ldx);
    __syncthreads();
    head<D / 2>(buf_b, ldx, net.w[13], net.b[11], hout + 4 * p0, 0, 3);
    __syncthreads();
  }

  // ---- alpha and the f32 composite ------------------------------------------
  for (int s = tid; s < S; s += kThreads) {
    const float raw = hout[4 * s + 3];
    const float sigma =
        occ_softplus ? fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw))) : fmaxf(raw, 0.f);
    const float occ = head_dist_alpha ? sigma : 1.f - expf(-sigma);
    float a = occ;
    if (dist_alpha) a = (s == S - 1) ? 1.f : 1.f - expf(-occ * (fz[s + 1] - fz[s]));
    alpha[s] = a;
  }
  __syncthreads();
  for (int s = tid; s < S; s += kThreads)
    scan0[s] = s >= 1 ? logf(1.f - alpha[s - 1] + kEps) : 0.f;
  __syncthreads();
  float* src = scan0;
  float* dst = scan1;
  for (int d = 1; d < S; d <<= 1) {
    for (int s = tid; s < S; s += kThreads) dst[s] = s >= d ? src[s] + src[s - d] : src[s];
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

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
