// Point-query NeRF MLP backward on Hopper (sm_90a): the VJP of point_mlp_fwd.cu's
// function, the forward recomputed per pass.
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_mlp.py::_bwd_kernel (reached
// through _raw_backward, the custom VJP of nerf_apply_fused) together with the
// head VJP and the encoding VJP that the JAX package runs around it in XLA
// (pallas_mlp.py:421-442). Inputs: the points and directions (M, 3) and the
// cotangents of the outputs, g_rgb (M, 3) and g_density (M, 1), f32. Per pass
// of 128 points:
//   the forward as point_mlp_fwd.cu (the same device code), every activation
//   written to this CTA's stash;
//   the head VJP in f32 (sigmoid, softplus or relu, 1 - exp(-sigma));
//   the MLP backward with the TPU kernel's rounding: every cotangent rounded
//   to bf16 before it enters a product (dX = g W^T, dW = x^T g), ReLU masks
//   from the bf16 activations, bias gradients summed from the f32 cotangents;
//   the encodings' f32 cotangents pulled through the encodings to the points
//   and directions inside the kernel, with the forward's own f32 sin/cos.
// Outputs: dW (14 blocks, stored (in, out)) and dB (12) in the layout of
// nerf_bwd.cuh's grad_layout, d(points) (M, 3), d(directions) (M, 3).
//
// The encoding VJP runs here, as in the render-backward kernels
// (nerf_bwd.cuh::enc_lane_grad), and not in plain torch from (M, 64) and
// (M, 32) f32 cotangents as the JAX package does: at the fine pass's 196,608
// points those would be 75 MB written and read again for 4.7 MB of result.
//
// Bound: compute: forward + dX + dW are three products per layer, 3.56 MFLOP a
// point, against 64 bytes of input and output per point and the weights and
// their gradients once. The kernel's activation stash (4.9 KB per point,
// written and read back) is its own choice and stays out of the bound.
//
// Design: the render-backward kernel's (render_train.cu, render_bwd.cu) on
// passes of 128 points. One persistent CTA per SM grid-strides over the
// passes; each CTA has its own stash (one pass, in device memory) and its own
// partial dW/dB buffer, and a second launch sums the partial buffers in CTA
// order: no float atomics, so two launches give the same bits. Shared memory
// holds three 128 x (D+8) activation buffers, the pass's direction
// encodings, head values and cotangents (226 KB at D = 256).

#include "point_mlp.cuh"

namespace {

// Per-CTA shared memory of the backward, in the order bwd_smem_bytes counts it.
struct PointCtx {
  bf16 *buf_a, *buf_b, *buf_c;  // three 128 x (D+8) activation / cotangent buffers
  bf16* de;       // direction encodings of the pass             (128, 40)
  float* hout;    // raw rgb (0-2) | raw density                 (128, 4)
  float* grgb;    // cotangent of the raw rgb                    (128, 4)
  float* graw;    // cotangent of the raw density                (128)
  float* gsbf;    // bf16-valued graw                            (128)
  float* xs;      // points                                      (128, 3)
  float* ds;      // directions                                  (128, 3)
  float* red;     // reduction scratch                           (kRed)
};

template <int D>
size_t bwd_smem_bytes() {
  return sizeof(bf16) * (3 * act_elems<D>() + static_cast<size_t>(kPts) * kLdDe) +
         sizeof(float) * (static_cast<size_t>(kPts) * (4 + 4 + 1 + 1 + 3 + 3) + kRed);
}

template <int D>
__device__ __forceinline__ PointCtx point_ctx(unsigned char* smem) {
  PointCtx c;
  c.buf_a = reinterpret_cast<bf16*>(smem);
  c.buf_b = c.buf_a + act_elems<D>();
  c.buf_c = c.buf_b + act_elems<D>();
  c.de = c.buf_c + act_elems<D>();
  c.hout = reinterpret_cast<float*>(c.de + kPts * kLdDe);
  c.grgb = c.hout + 4 * kPts;
  c.graw = c.grgb + 4 * kPts;
  c.gsbf = c.graw + kPts;
  c.xs = c.gsbf + kPts;
  c.ds = c.xs + 3 * kPts;
  c.red = c.ds + 3 * kPts;
  return c;
}

// The f32 cotangents of one warp's 16 rows of a dense-lane encoding (levels
// `levels`, NT n-tiles of 8 lanes in acc, the mma accumulator layout) pulled
// through the encoding to each row's 3 coordinates x[3*row..], summed over the
// row's lanes and written to out[3*(p0 + row) + c] for rows < n.
template <int NT>
__device__ __forceinline__ void coord_grad(float (&acc)[1][NT][4], const float* x,
                                           int levels, int m0, int gq, int t, int n,
                                           long long p0, float* __restrict__ out) {
#pragma unroll
  for (int hrow = 0; hrow < 2; ++hrow) {
    const int m = m0 + gq + 8 * hrow;
    float d[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        int c;
        const float tv = enc_lane_grad(acc[0][j][2 * hrow + hc], x + 3 * m, 8 * j + 2 * t + hc,
                                       levels, &c);
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          if (c == cc) d[cc] += tv;
      }
    }
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      d[cc] += __shfl_xor_sync(0xffffffffu, d[cc], 1);
      d[cc] += __shfl_xor_sync(0xffffffffu, d[cc], 2);
    }
    if (t == 0 && m < n) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) out[3 * (p0 + m) + cc] = d[cc];
    }
  }
}

// Forward with stash, head VJP and MLP backward of one pass of n points at p0.
template <int D>
__device__ void backward_pass(const PointCtx& c, const Net& net, const NetT& nett,
                              const GradLayout& lay, float* part, bf16* st,
                              const float* __restrict__ pts, const float* __restrict__ dirs,
                              const float* __restrict__ g_rgb, const float* __restrict__ g_density,
                              float* __restrict__ dpts, float* __restrict__ ddirs, long long p0,
                              int n, int occ_softplus, int head_dist_alpha) {
  constexpr int ldx = D + kPad;
  constexpr int H = D / 2;
  constexpr size_t slot = static_cast<size_t>(kPts) * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;

  // ---- forward, every activation stashed ------------------------------------
  load_points(c.xs, c.ds, pts, dirs, p0, n);
  __syncthreads();
  encode_points(c.buf_c, kLdPe, c.de, c.xs, c.ds);
  __syncthreads();
  point_mlp_pass<D, true>(net, c.buf_c, c.de, c.buf_a, c.buf_b, c.hout, st);

  // ---- head VJP (f32); rows of a ragged pass get zero cotangents -------------
  if (tid < kPts) {
    const bool live = tid < n;
    const float raw = c.hout[4 * tid + 3];
    const float gd = live ? g_density[p0 + tid] : 0.f;
    const float sigma = density_act(raw, occ_softplus);
    const float g_sigma = head_dist_alpha ? gd : gd * expf(-sigma);
    c.graw[tid] =
        occ_softplus ? g_sigma * (1.f / (1.f + expf(-raw))) : (raw > 0.f ? g_sigma : 0.f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = 1.f / (1.f + expf(-c.hout[4 * tid + k]));
      c.grgb[4 * tid + k] = (live ? g_rgb[3 * (p0 + tid) + k] : 0.f) * (s * (1.f - s));
    }
  }
  __syncthreads();

  bf16* bufg = c.buf_a;     // current cotangent
  bf16* bufx = c.buf_b;     // activation read back from the stash
  bf16* bufo = c.buf_c;     // cotangent being produced

  // ---- rgb head: dW[13] = h^T g_rgb, dB[11], g_h = (g_rgb wo^T) * (h > 0) ------
  stash_load<H>(bufx, ldx, st + 9 * slot);
  if (tid < kPts) c.gsbf[tid] = bf16_round(c.graw[tid]);
  __syncthreads();
  {
    constexpr int NG = kThreads / H;         // row groups, each of kPts / NG rows
    const int j = tid % H, grp = tid / H;
    const float wo0 = __bfloat162float(net.w[13][j]);
    const float wo1 = __bfloat162float(net.w[13][H + j]);
    const float wo2 = __bfloat162float(net.w[13][2 * H + j]);
    float cs = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
    for (int m = grp * (kPts / NG); m < (grp + 1) * (kPts / NG); ++m) {
      const float g0 = bf16_round(c.grgb[4 * m]), g1 = bf16_round(c.grgb[4 * m + 1]),
                  g2 = bf16_round(c.grgb[4 * m + 2]);
      const float hv = __bfloat162float(bufx[m * ldx + j]);
      float gh = g0 * wo0 + g1 * wo1 + g2 * wo2;
      if (!(hv > 0.f)) gh = 0.f;
      bufg[m * ldx + j] = __float2bfloat16_rn(gh);
      cs += gh;
      d0 += hv * g0;
      d1 += hv * g1;
      d2 += hv * g2;
    }
    float* r = c.red + 4 * tid;
    r[0] = cs;
    r[1] = d0;
    r[2] = d1;
    r[3] = d2;
    __syncthreads();
    if (tid < H) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int gi = 0; gi < NG; ++gi)
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] += c.red[4 * (gi * H + tid) + k];
      part[lay.b[10] + tid] += v[0];
      part[lay.w[13] + 3 * tid] += v[1];
      part[lay.w[13] + 3 * tid + 1] += v[2];
      part[lay.w[13] + 3 * tid + 2] += v[3];
    } else if (tid < H + 4) {      // dB[11] (3) and dB[8]: f32 sums over the pass
      const int k = tid - H;
      float acc = 0.f;
      if (k < 3) {
        for (int m = 0; m < kPts; ++m) acc += c.grgb[4 * m + k];
        part[lay.b[11] + k] += acc;
      } else {
        for (int m = 0; m < kPts; ++m) acc += c.graw[m];
        part[lay.b[8]] += acc;
      }
    }
    __syncthreads();
  }

  // ---- rgb hidden: dW[11] = feat^T g_h, dW[12] = de^T g_h, g_feat = g_h wrx^T --
  stash_load<D>(bufx, ldx, st + 8 * slot);
  __syncthreads();
  dw_accum<D, H>(bufx, ldx, bufg, ldx, part + lay.w[11]);
  dw_accum<kDe, H>(c.de, kLdDe, bufg, ldx, part + lay.w[12]);
  dense_bwd<H, D, false, false>(bufg, ldx, nett.w[11], nullptr, 0, nullptr, nullptr, bufo, ldx,
                                c.red);
  __syncthreads();
  bias_accum<D>(c.red, part + lay.b[9]);
  {  // d(directions) = (g_h wrde^T) through the direction encoding, per point
    float acc[1][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[0][j][k] = 0.f;
    mma_tile<H, 1, 4>(acc, bufg, ldx, nett.w[12], 16 * warp, 0, gq, t);
    coord_grad<4>(acc, c.ds, 4, 16 * warp, gq, t, n, p0, ddirs);
  }

  // ---- feature + density heads: dW[10] = x7^T g_feat, dW[9] = x7^T g_sig,
  //      g7 = (g_feat wf^T + g_sig wd^T) * (x7 > 0) ------------------------------
  stash_load<D>(bufx, ldx, st + 7 * slot);
  __syncthreads();
  dw_accum<D, D>(bufx, ldx, bufo, ldx, part + lay.w[10]);
  for (int i = tid; i < D; i += kThreads) {
    float acc = 0.f;
    for (int m = 0; m < kPts; ++m) acc += __bfloat162float(bufx[m * ldx + i]) * c.gsbf[m];
    part[lay.w[9] + i] += acc;
  }
  dense_bwd<D, D, true, true>(bufo, ldx, nett.w[10], bufx, ldx, c.gsbf, net.w[9], bufg, ldx,
                              c.red);
  __syncthreads();
  bias_accum<D>(c.red, part + lay.b[7]);

  // ---- trunk layers 7..1: dW = x_{l-1}^T g_l, g_{l-1} = (g_l W^T) * (x_{l-1} > 0)
#pragma unroll 1
  for (int l = 7; l >= 1; --l) {
    const int wi = l >= 5 ? l + 1 : l;
    stash_load<D>(bufx, ldx, st + static_cast<size_t>(l - 1) * slot);
    __syncthreads();
    dw_accum<D, D>(bufx, ldx, bufg, ldx, part + lay.w[wi]);
    dense_bwd<D, D, true, false>(bufg, ldx, nett.w[wi], bufx, ldx, nullptr, nullptr, bufo, ldx,
                                 c.red);
    __syncthreads();
    bias_accum<D>(c.red, part + lay.b[l - 1]);
    // g4 waits in the slot x4 has just vacated, for the encoding gradients
    if (l == 5) stash_store<D>(bufo, ldx, st + 4 * slot);
    bf16* tmp = bufg;
    bufg = bufo;
    bufo = tmp;
  }

  // ---- first and skip layer, encoding side: dW[0] = pe^T g0, dW[5] = pe^T g4,
  //      dpe = g0 w0^T + g4 w4pe^T, then through the encoding to the points ----
  encode_points(bufx, kLdPe, nullptr, c.xs, nullptr);
  __syncthreads();                              // also orders the g4 stash round trip
  stash_load<D>(bufo, ldx, st + 4 * slot);
  __syncthreads();
  dw_accum<kPe, D>(bufx, kLdPe, bufg, ldx, part + lay.w[0]);
  dw_accum<kPe, D>(bufx, kLdPe, bufo, ldx, part + lay.w[5]);
  {
    float acc[1][8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[0][j][k] = 0.f;
    mma_tile<D, 1, 8>(acc, bufg, ldx, nett.w[0], 16 * warp, 0, gq, t);
    mma_tile<D, 1, 8>(acc, bufo, ldx, nett.w[5], 16 * warp, 0, gq, t);
    coord_grad<8>(acc, c.xs, 10, 16 * warp, gq, t, n, p0, dpts);
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
point_mlp_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                     const float* __restrict__ g_rgb, const float* __restrict__ g_density,
                     Net net, NetT nett, bf16* stash, float* partials, float* __restrict__ dpts,
                     float* __restrict__ ddirs, long long M, int occ_softplus,
                     int head_dist_alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GradLayout lay = grad_layout(D);
  const PointCtx c = point_ctx<D>(smem_raw);
  bf16* st = stash + static_cast<size_t>(blockIdx.x) * stash_elems<D>();
  float* part = partials + static_cast<size_t>(blockIdx.x) * lay.total;
  for (int e = threadIdx.x; e < lay.total / 4; e += kThreads)
    reinterpret_cast<float4*>(part)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const long long n_pass = (M + kPts - 1) / kPts;
  for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x) {
    const long long p0 = pass * kPts;
    const int n = static_cast<int>(M - p0 < kPts ? M - p0 : kPts);
    backward_pass<D>(c, net, nett, lay, part, st, pts, dirs, g_rgb, g_density, dpts, ddirs, p0,
                     n, occ_softplus, head_dist_alpha);
  }
}

template <int D>
cudaError_t launch_bwd(const float* pts, const float* dirs, const float* g_rgb,
                       const float* g_density, const Net& net, const NetT& nett, bf16* stash,
                       float* partials, float* grads, float* dpts, float* ddirs, long long M,
                       int n_ctas, int occ_softplus, int head_dist_alpha, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(point_mlp_bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  point_mlp_bwd_kernel<D><<<n_ctas, kThreads, smem, stream>>>(
      pts, dirs, g_rgb, g_density, net, nett, stash, partials, dpts, ddirs, M, occ_softplus,
      head_dist_alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = grad_layout(D).total;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partials, grads, total, n_ctas);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_mlp.py.

// Offsets (floats) of the 14 dW blocks and the 12 dB blocks in the gradient
// buffer, into offsets[26]; returns the buffer's length, or 0 for a width the
// kernel is not built for. (nerf_bwd.cuh's layout; its 3 loss sums stay unused.)
extern "C" int nerf_point_mlp_grad_layout(int D, int* offsets) {
  if (D != 128 && D != 256) return 0;
  const GradLayout lay = grad_layout(D);
  for (int i = 0; i < 14; ++i) offsets[i] = lay.w[i];
  for (int i = 0; i < 12; ++i) offsets[14 + i] = lay.b[i];
  return lay.total;
}

// pts, dirs, g_rgb (M, 3) and g_density (M, 1) f32, contiguous on the device;
// weights (out, in), weights_t (in, out): 14 bf16 device pointers each in the
// Net layout; biases: 12 f32 pointers. stash: n_ctas * 128 * 9.5 D bf16.
// partials: n_ctas * total f32 (scratch), grads: total f32 (out). dpts, ddirs
// (M, 3) f32 (out). 0 < n_ctas <= the number of 128-point passes. Returns a
// cudaError_t (0 on success); the launches are asynchronous on `stream`.
extern "C" int nerf_point_mlp_bwd(const float* pts, const float* dirs, const float* g_rgb,
                                  const float* g_density, const void* const* weights,
                                  const void* const* weights_t, const void* const* biases,
                                  void* stash, float* partials, float* grads, float* dpts,
                                  float* ddirs, long long M, int D, int n_ctas, int occ_softplus,
                                  int head_dist_alpha, int total, void* stream) {
  const long long n_pass = (M + kPts - 1) / kPts;
  if (M <= 0 || n_ctas <= 0 || n_ctas > n_pass) return static_cast<int>(cudaErrorInvalidValue);
  if ((D != 128 && D != 256) || total != grad_layout(D).total)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  NetT nett;
  for (int i = 0; i < 14; ++i) {
    net.w[i] = static_cast<const bf16*>(weights[i]);
    nett.w[i] = static_cast<const bf16*>(weights_t[i]);
  }
  for (int i = 0; i < 12; ++i) net.b[i] = static_cast<const float*>(biases[i]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* sp = static_cast<bf16*>(stash);
  cudaError_t err = D == 256
      ? launch_bwd<256>(pts, dirs, g_rgb, g_density, net, nett, sp, partials, grads, dpts, ddirs,
                        M, n_ctas, occ_softplus, head_dist_alpha, st)
      : launch_bwd<128>(pts, dirs, g_rgb, g_density, net, nett, sp, partials, grads, dpts, ddirs,
                        M, n_ctas, occ_softplus, head_dist_alpha, st);
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
