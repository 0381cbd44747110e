// The dX chain on Hopper (sm_90a), shared by every backward kernel of the
// NeRF MLP: render_bwd_frozen.cu (K4's frozen-network variant),
// point_mlp_bwd_frozen.cu (K6's), point_mlp_bwd.cu (K6 full) and
// render_full_sm90.cuh (K1 and K4 full): one 128-point tile through the
// forward of mlp_fwd_sm90.cuh (mlp_tile_masks, the one K3 and K5 run, with
// its ReLU masks kept), then back through every layer's dX = g W product to
// the cotangent of the position encoding. No weight gradient is formed here:
// the full kernels save the operands of their dW products through the
// forward's save hook and their own dX layers, sum their bias gradients in
// store_dx's epilogue (SUM) and hand the products to dw_sm90.cuh
// (mlp_dw_chain_sm90.cuh). The render kernels' per-ray pieces (the producer,
// the composite forward and backward, the encoding VJPs) close this file.
//
// Numerics are the TPU kernels' (pallas_mlp.py::_bwd_chain_core), in a
// fixed order:
// - the forward's, K3's and K5's bits (mlp_fwd_sm90.cuh: each 64-column
//   ring slice of K summed from zero, added in f32 to the accumulator that
//   starts at the bias, slice by slice in order);
// - every cotangent rounded to bf16 before it enters a product, each product
//   summed from zero over 16-column steps of K in order, then in the
//   epilogue's order: + gs wd (the density head's rank-1 term), the ReLU
//   mask, the bf16 rounding;
// - the masks from the bf16 activations (bf16(relu(x)) > 0);
// - the rgb head's backward in scalar f32, a thread per (column, row group),
//   its column sums over the row groups in order;
// - dpe = g0 W0 summed first, then g4 W5pe into the same accumulator;
// - the encoding derivative per lane in enc_lane_grad's order (over j, then
//   hc), the per-row sums by shfl_xor over 1 then 2, the block sums over the
//   8 consumer warps in order: consumer warp w of warpgroup g owns rows
//   64g + 16w.
//
// Design:
// - The CTA is mlp_fwd_sm90.cuh's: two consumer warpgroups and a producer
//   warpgroup, persistent, one CTA per SM; the producer's first warp streams
//   weight slices through the ring by cp.async.bulk with mbarriers, its
//   other three warps encode the next tile. The ring carries the forward
//   slices (pack_tiles) and then the backward's (pack_tiles_dx), one
//   sequence the producer and the consumers both know in advance.
// - Warpgroup g owns rows 64g..64g+63 of the tile in the forward and in the
//   backward. A dX product is one wgmma m64nNk16 per 16 columns of K (K = the
//   layer's outputs, N = its inputs), A = the cotangent in the shared
//   activation buffer (128-byte swizzle), B = a ring slice: a 64-column block
//   of the (in, out) weight, N rows of 128 bytes. The epilogue writes the new
//   cotangent over the old one, as the forward writes each layer's output
//   over its input: one 128 x D buffer serves the whole chain.
// - A frozen network needs no activations in the backward, only their ReLU
//   masks. The forward's epilogue keeps one bit per activation in shared
//   memory, in the accumulator's own layout, so that the thread that wrote a
//   bit in the forward is the thread that reads it in the backward's
//   epilogue of the same layer: 8 x 128 x D bits for x0..x7 (32 KB at
//   D=256) and 128 x D/2 for the rgb-hidden layer. No activation goes to
//   device memory and none is read back.
//
// The two tight points:
// (a) g4, the skip layer's cotangent, enters the encoding product last (dpe
//     sums g0 W0 first, and that order is binding for bit-equality between
//     the variants), but its
//     64 KB (D=256) must leave the activation buffer to the four layers
//     after it, and no other 64 KB of shared memory is free. Each warpgroup
//     writes its 64 rows of g4 to a per-CTA scratch in device memory
//     straight from the epilogue's registers (128 x D bf16 a CTA: 8.4 MB for
//     132 CTAs, which stays in the 50 MB L2), and reads them back with
//     cp.async over g0 once g0's products are done: 2 x 64 KB of L2
//     traffic a tile. (The full kernels read it back from its G operand.)
//     (Keeping g4 as wgmma A fragments in registers would take 64 registers
//     a thread beside the 128 of the accumulator.)
// (b) S > 128 in K1 and K4: the composite backward needs the head outputs of
//     the whole ray before any tile's MLP backward, and the masks of two
//     tiles (68 KB) do not fit beside the ring. The ray's forward runs once
//     over every tile for the head outputs and again per tile, before that
//     tile's backward, for its masks; with one tile (S = 128, the pose-opt
//     path) the masks of the first forward serve and nothing runs twice. A
//     ray's per-sample f32 arrays (11 floats a sample of its own, 5 of the
//     composite's) stay in shared memory while they fit and go to a per-CTA
//     scratch in device memory past that (mlp_fwd_sm90.cuh's RayPlace), so
//     S is bounded by nothing but S % 128 == 0.
//
// Shared memory at D=256: mlp_fwd_sm90.cuh's Layout90 (activations and
// cotangents 64 KB, position encodings 16 KB, +16 KB of directions in K6,
// resident heads 6 KB, as many 32 KB ring stages as fit, barriers), whose
// trailing area holds the masks (34 KB, mask_bytes) and then the kernel's f32
// arrays: K4 keeps 3 ring stages at S=128 and 2 at S=256, K6 2.

#pragma once

#include "mlp_fwd_sm90.cuh"
#include "nerf_bwd.cuh"   // bf16_round, enc_lane_grad

namespace {

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// The backward's weight buffer of ops/fused_render.py::pack_tiles_dx, in
// bytes: 64-column (output) blocks of each (in, out) weight, N = in rows of
// 128 bytes, 128-byte swizzle, in the order the chain consumes them:
//   w12 (H/64 slices of 32 rows; K6 only, K4 starts after them),
//   w11 (H/64 of D rows), w10, w8, w7, w6, w4, w3, w2, w1 (D/64 of D rows each),
//   w0, w5's encoding part (D/64 of 64 rows each).
template <int D, bool DIRS>
struct TilesDx {
  static constexpr int H = D / 2;
  static constexpr int kDir = H / 64;
  static constexpr int kFullSlices = H / 64 + 8 * (D / 64);
  static constexpr int kEnc = 2 * (D / 64);
  static constexpr int kFirst = DIRS ? 0 : kDir;
  static constexpr int kEnd = kDir + kFullSlices + kEnc;
  static constexpr uint32_t kDirBytes = 32 * 128;
  static constexpr uint32_t kFullBytes = D * 128;
  static constexpr uint32_t kEncBytes = 64 * 128;
  __device__ static size_t offset(int i) {
    if (i < kDir) return static_cast<size_t>(i) * kDirBytes;
    const size_t dir = static_cast<size_t>(kDir) * kDirBytes;
    if (i < kDir + kFullSlices) return dir + static_cast<size_t>(i - kDir) * kFullBytes;
    return dir + static_cast<size_t>(kFullSlices) * kFullBytes +
           static_cast<size_t>(i - kDir - kFullSlices) * kEncBytes;
  }
  __device__ static uint32_t bytes(int i) {
    return i < kDir ? kDirBytes : (i < kDir + kFullSlices ? kFullBytes : kEncBytes);
  }
};

// The producer's side of the ring: slices in the consumers' order.
struct Feeder {
  Ring ring;
  __device__ __forceinline__ void push(const unsigned char* src, uint32_t bytes) {
    const uint32_t stage = ring.it % ring.stages;
    mbar_wait(ring.empty + 8 * stage, ((ring.it / ring.stages) & 1) ^ 1);
    mbar_expect_tx(ring.full + 8 * stage, bytes);
    bulk_load(ring.base + stage * ring.stride, src, bytes, ring.full + 8 * stage);
    ++ring.it;
  }
  template <int D>
  __device__ __forceinline__ void forward(const unsigned char* w, int slices) {
    for (int i = 0; i < slices; ++i) push(w + Tiles<D>::offset(i), Tiles<D>::bytes(i));
  }
  template <int D, bool DIRS>
  __device__ __forceinline__ void backward(const unsigned char* w) {
    using T = TilesDx<D, DIRS>;
    for (int i = T::kFirst; i < T::kEnd; ++i) push(w + T::offset(i), T::bytes(i));
  }
};

// nerf_bwd.cuh's enc_lane_grad with its cosine or sine evaluated out of line:
// the same operations in the same order (its results bit for bit), but one
// copy of the accurate sinf/cosf code where an unrolled loop over a row's
// lanes inlines sixteen; the encoding VJP takes a fifth fewer cycles
// (tools/frozen_profile.py). x: the three coordinates, read by selects only,
// so that they stay in registers.
__device__ __noinline__ float lane_trig(float a, bool is_sin) { return is_sin ? cosf(a) : sinf(a); }

__device__ __forceinline__ float enc_lane_grad90(float g, const float* x, int e, int levels,
                                                 int* c_out) {
  if (e < 3) {
    *c_out = e;
    return g;
  }
  int q = e - 3;
  const bool is_sin = q < 3 * levels;
  if (!is_sin) q -= 3 * levels;
  if (q >= 3 * levels) {
    *c_out = -1;
    return 0.f;
  }
  const int c = q % 3;
  const float scale = static_cast<float>(1 << (q / 3));
  const float a = (c == 0 ? x[0] : (c == 1 ? x[1] : x[2])) * scale;
  *c_out = c;
  const float tr = lane_trig(a, is_sin);
  return (is_sin ? g * tr : -(g * tr)) * scale;
}

// ---- ReLU masks (mlp_fwd_sm90.cuh's layout) ------------------------------------

// The mask bit of row m (of the tile), column j of the rgb-hidden layer,
// whoever wrote it (the scalar rgb-head backward reads other threads' bits).
__device__ __forceinline__ bool hidden_mask(const uint32_t* mask_h, int m, int j) {
  const int thread = (m >> 6) * 128 + ((m & 63) >> 4) * 32 + (m & 7) * 4 + ((j & 7) >> 1);
  const int half = (m >> 3) & 1;
  return (mask_h[half * kConsumers + thread] >> (2 * (j >> 3) + (j & 1))) & 1u;
}

// ---- the dX chain ---------------------------------------------------------------

// The warpgroup's rows of the new cotangent = bf16(mask * (acc [+ gs wd])),
// over the old one in the activation buffer; with SAVE also to `save_wg`
// (device memory, the warpgroup's 64 rows in the same swizzle, 64-column
// blocks kWgRowBytes apart), in the epilogue's order.
//
// With SUM, the f32 column sums of the warpgroup's rows of mask * (acc [+ gs
// wd]), before the rounding (the bias gradients' terms), go to red_wg[w][N] for
// each of its warps w: over the thread's two rows, then the warp's eight row
// groups by shfl_xor over 4, 8, 16.
template <int N, bool MASK, bool RANK1, bool SAVE, bool SUM = false>
__device__ __forceinline__ void store_dx(const float (&acc)[N / 2], unsigned char* act_wg,
                                         const uint32_t* mask, const float* gs_wg,
                                         const unsigned char* dens_head, unsigned char* save_wg,
                                         float* red_wg = nullptr) {
  constexpr int W = mask_words<N>();
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int row = 16 * w + (lane >> 2), t = lane & 3;
  uint32_t bits[2][W];
  if (MASK) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      bits[0][k] = mask[k * kConsumers + threadIdx.x];
      bits[1][k] = mask[(W + k) * kConsumers + threadIdx.x];
    }
  }
  float gs0 = 0.f, gs1 = 0.f;
  if (RANK1) {
    gs0 = gs_wg[row];
    gs1 = gs_wg[row + 8];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t;
    float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
    if (RANK1) {
      const float wd0 = __bfloat162float(*reinterpret_cast<const bf16*>(dens_head + swz(0, col, 1024)));
      const float wd1 =
          __bfloat162float(*reinterpret_cast<const bf16*>(dens_head + swz(0, col + 1, 1024)));
      v0 += gs0 * wd0;
      v1 += gs0 * wd1;
      v2 += gs1 * wd0;
      v3 += gs1 * wd1;
    }
    if (MASK) {
      const int b = (2 * j) & 31, k = (2 * j) >> 5;
      if (!((bits[0][k] >> b) & 1u)) v0 = 0.f;
      if (!((bits[0][k] >> (b + 1)) & 1u)) v1 = 0.f;
      if (!((bits[1][k] >> b) & 1u)) v2 = 0.f;
      if (!((bits[1][k] >> (b + 1)) & 1u)) v3 = 0.f;
    }
    if (SUM) {
      float s0 = v0 + v2, s1 = v1 + v3;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if ((lane >> 2) == 0) {
        red_wg[w * N + col] = s0;
        red_wg[w * N + col + 1] = s1;
      }
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1), hi = __floats2bfloat162_rn(v2, v3);
    *reinterpret_cast<__nv_bfloat162*>(act_wg + swz(row, col, kBlockBytes)) = lo;
    *reinterpret_cast<__nv_bfloat162*>(act_wg + swz(row + 8, col, kBlockBytes)) = hi;
    if (SAVE) {   // past L1 (st.global.cg): the forward's biases stay there
      __stcg(reinterpret_cast<unsigned int*>(save_wg + swz(row, col, kWgRowBytes)),
             *reinterpret_cast<const unsigned int*>(&lo));
      __stcg(reinterpret_cast<unsigned int*>(save_wg + swz(row + 8, col, kWgRowBytes)),
             *reinterpret_cast<const unsigned int*>(&hi));
    }
  }
  fence_proxy_async();
}

// One dX layer on the warpgroup's rows: g_in = epilogue(g_out W) over the
// next K/64 ring slices (N rows each).
template <int K, int N, bool MASK, bool RANK1, bool SAVE>
__device__ __forceinline__ void dx_layer(unsigned char* act_wg, uint32_t act_s, Ring& ring,
                                         const uint32_t* mask, const float* gs_wg,
                                         const unsigned char* dens_head, unsigned char* save_wg) {
  const int wg = threadIdx.x >> 7;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  ring_products<N>(acc, act_s, K / 64, 4, ring);
  wg_sync(wg);
  store_dx<N, MASK, RANK1, SAVE>(acc, act_wg, mask, gs_wg, dens_head, save_wg);
  wg_sync(wg);
}

// The rgb head's backward for the tile, scalar f32: with
// j = tid % H and row group tid / H, g_h[m][j] = (bf16 g_rgb[m] . wo[:, j]) *
// (h[m][j] > 0), rounded to bf16 into the activation buffer (every row: both
// warpgroups). With ghsum, each thread's sum of its rows' bf16 g_h goes to
// red[tid] and ghsum[j] += the row groups' sums in order. grgb: the tile's
// raw-rgb cotangents (128 x 4 f32). Ends synchronised (both warpgroups) with
// the buffer fenced for wgmma.
template <int D>
__device__ __forceinline__ void rgb_head_bwd(unsigned char* act, const float* grgb,
                                             const uint32_t* mask_h, const unsigned char* rgb_head,
                                             float* red, float* ghsum) {
  constexpr int H = D / 2;
  constexpr int NG = kConsumers / H;        // row groups, each of kPts / NG rows
  const int tid = threadIdx.x;
  const int j = tid % H, grp = tid / H;
  const float wo0 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(0, j, 1024)));
  const float wo1 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(1, j, 1024)));
  const float wo2 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(2, j, 1024)));
  float csb = 0.f;
  consumer_sync();   // both warpgroups are done with the buffer and the masks are in
#pragma unroll 8
  for (int m = grp * (kPts / NG); m < (grp + 1) * (kPts / NG); ++m) {
    const float g0 = bf16_round(grgb[4 * m]), g1 = bf16_round(grgb[4 * m + 1]),
                g2 = bf16_round(grgb[4 * m + 2]);
    float gh = g0 * wo0 + g1 * wo1 + g2 * wo2;
    if (!hidden_mask(mask_h, m, j)) gh = 0.f;
    const bf16 ghb = __float2bfloat16_rn(gh);
    *reinterpret_cast<bf16*>(act + swz(m, j, kBlockBytes)) = ghb;
    csb += __bfloat162float(ghb);
  }
  fence_proxy_async();
  if (ghsum != nullptr) red[tid] = csb;
  consumer_sync();
  if (ghsum != nullptr) {
    if (tid < H) {
      float v = 0.f;
      for (int gi = 0; gi < NG; ++gi) v += red[gi * H + tid];
      ghsum[tid] += v;
    }
    consumer_sync();
  }
}

// The dX chain of the tile from g_h (in the buffer) to the cotangent of the
// position encoding: feat <- h (w11), x7 <- feat (w10, + gs wd, mask x7),
// x_{l-1} <- x_l (w8..w6, w4..w1, masks x6..x0), g4 parked in `save`
// (this CTA's scratch: 128 x D bf16), then dpe = g0 W0 + g4 W5pe into
// `dpe` (the m64n64 fragment of the warpgroup's rows). gsbf: the tile's
// bf16-valued raw-density cotangents (128 f32).
template <int D>
__device__ __forceinline__ void dx_chain(float (&dpe)[32], unsigned char* act, Ring& ring,
                                         const uint32_t* masks, const float* gsbf,
                                         const unsigned char* dens_head, unsigned char* save) {
  constexpr int H = D / 2;
  constexpr int LW = mask_layer_words<D>();
  const int wg = threadIdx.x >> 7;
  unsigned char* act_g = act + wg * kWgRowBytes;
  const uint32_t act_s = smem_addr(act) + wg * kWgRowBytes;
  unsigned char* save_wg = save + wg * (kWgRowBytes * (D / 64));
  const float* gs_wg = gsbf + 64 * wg;
  dx_layer<H, D, false, false, false>(act_g, act_s, ring, nullptr, nullptr, nullptr, nullptr);
  dx_layer<D, D, true, true, false>(act_g, act_s, ring, masks + 7 * LW, gs_wg, dens_head,
                                    nullptr);
#pragma unroll 1
  for (int l = 7; l >= 1; --l) {
    if (l == 5)
      dx_layer<D, D, true, false, true>(act_g, act_s, ring, masks + 4 * LW, nullptr, nullptr,
                                        save_wg);
    else
      dx_layer<D, D, true, false, false>(act_g, act_s, ring, masks + (l - 1) * LW, nullptr,
                                         nullptr, nullptr);
  }
  __threadfence_block();   // g4's device-memory writes, before other threads read them back
#pragma unroll
  for (int i = 0; i < 32; ++i) dpe[i] = 0.f;
  ring_products<64>(dpe, act_s, D / 64, 4, ring);   // g0 W0
  wg_sync(wg);
  // g4 back over g0, by 16-byte cp.async
  {
    constexpr int kChunks = (D / 64) * (kWgRowBytes / 16);
    const int lt = threadIdx.x & 127;
    for (int e = lt; e < kChunks; e += 128) {
      const int blk = e / (kWgRowBytes / 16), within = (e % (kWgRowBytes / 16)) * 16;
      const uint32_t dst = act_s + blk * kBlockBytes + within;
      const unsigned char* src = save_wg + blk * kWgRowBytes + within;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    fence_proxy_async();
  }
  wg_sync(wg);
  ring_products<64>(dpe, act_s, D / 64, 4, ring);   // + g4 W5pe
}

// The f32 cotangents of an encoding (levels `levels`) in the m64nN fragment
// acc (NT n-tiles of 8 lanes) pulled to the 3 coordinates of each of the
// thread's two rows, summed over the rows' lanes in order and written to out[3 * (p0 + m) + c] for rows
// m < n. src: the (M, 3) coordinates the forward encoded.
template <int NT>
__device__ __forceinline__ void coord_grad90(const float (&acc)[4 * NT],
                                             const float* __restrict__ src, int levels, int n,
                                             long long p0, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
#pragma unroll
  for (int hrow = 0; hrow < 2; ++hrow) {
    const int m = m0 + gq + 8 * hrow;
    float x[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = m < n ? src[3 * (p0 + m) + c] : 0.f;
    float d[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        int c;
        const float tv = enc_lane_grad90(acc[4 * j + 2 * hrow + hc], x, 8 * j + 2 * t + hc,
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

// ---- block-level helpers over the consumer threads ---------------------------

// A block sum over the 8 consumer warps (shuffles inside a warp,
// then the warps in order); the sums are left in red[0..N). Ends synchronised.
template <int N>
__device__ __forceinline__ void block_sum90(float (&part)[N], float* red) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  consumer_sync();
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < N; ++c) red[N * warp + c] = part[c];
  }
  consumer_sync();
  float acc = 0.f;
  if (threadIdx.x < N) {
    for (int w = 0; w < kConsumerWarps; ++w) acc += red[N * w + threadIdx.x];
  }
  consumer_sync();
  if (threadIdx.x < N) red[threadIdx.x] = acc;
  consumer_sync();
}

// ---- the render's per-ray pieces: K4's frozen variant (render_bwd_frozen.cu)
// and the kernels with weight gradients (render_full_sm90.cuh) --------------

// A ray's per-sample f32 arrays in those kernels (RayPlace): its own, z (S),
// the raw heads (4S), graw (S), grgb (4S) and gz (S); the composite's,
// alpha, weights, transmittance and the two scan buffers (S each).
constexpr int kRaySampleF32 = 11;
constexpr int kRayCompositeF32 = 5;

// render_fwd.cu's alpha_and_prefix90 over the consumer threads: alpha, then
// the f32 exclusive Hillis-Steele prefix sum of log(1 - alpha + eps).
// Returns the buffer holding the prefix sums.
__device__ __forceinline__ float* alpha_prefix90(const float* hout, const float* fz, float* alpha,
                                                 float* scan0, float* scan1, int S,
                                                 int occ_softplus, int head_dist_alpha,
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

// The consumer threads copy the forward buffer's w12 slice (D/2 rows of 128
// bytes, swizzled, 32 live columns) from device memory to `dst` in shared
// memory: a few 16-byte loads a thread in flight at once, where a chain of
// fmaf over single loads would wait on L2 once per term. The loads pass L1
// by (ld.global.cg), which keeps the forward's biases.
template <int D>
__device__ __forceinline__ void stage_w12(unsigned char* dst, const unsigned char* src) {
  for (int e = threadIdx.x; e < D / 2 * 128 / 16; e += kConsumers)
    reinterpret_cast<uint4*>(dst)[e] = __ldcg(reinterpret_cast<const uint4*>(src) + e);
}

// The producer warpgroup of a render backward kernel (persistent CTA,
// rays blockIdx.x, blockIdx.x + gridDim.x, ...): its first thread loads the
// heads and streams, per ray, the forward slices of its S/128 tiles, then per
// tile (after a second forward for its masks when S > 128) the backward's;
// warps 1..3 encode every forward tile's sample positions in the consumers'
// order, o + v*z by explicitly rounded mul and add.
template <int D>
__device__ __forceinline__ void render_producer90(const float* __restrict__ rays,
                                                  const float* __restrict__ z,
                                                  const unsigned char* __restrict__ tiles,
                                                  const unsigned char* __restrict__ tiles_dx,
                                                  const Ring& ring, uint32_t heads,
                                                  uint32_t head_bar, const Handoff& hand,
                                                  unsigned char* pe, int n_rays, int S) {
  using T = Tiles<D>;
  const int passes = S / kPts;
  const bool again = passes > 1;
  const long long mine = (n_rays - static_cast<long long>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int etid = threadIdx.x - kConsumers - 32;
  if (threadIdx.x == kConsumers) {
    mbar_expect_tx(head_bar, T::kDensHead + T::kRgbHead);
    bulk_load(heads, tiles + T::kHeads, T::kDensHead + T::kRgbHead, head_bar);
    Feeder f{ring};
    for (long long r = 0; r < mine; ++r) {
      for (int p = 0; p < passes; ++p) f.forward<D>(tiles, T::kRender);
      for (int p = 0; p < passes; ++p) {
        if (again) f.forward<D>(tiles, T::kRender);
        f.backward<D, false>(tiles_dx);
      }
    }
  } else if (etid >= 0) {
    long long tile = 0;
    for (long long r = blockIdx.x; r < n_rays; r += gridDim.x) {
      float o[3], v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c] = rays[r * 9 + c];
        v[c] = rays[r * 9 + 3 + c];
      }
      for (int k = 0; k < (again ? 2 : 1) * passes; ++k, ++tile) {
        wait_free(hand.pe_free, tile);
        const float* zt = z + r * S + (k % passes) * kPts;
        encode_tile<10, kPe>(pe, etid, [&](int p, int c) {
          const float oc = c == 0 ? o[0] : (c == 1 ? o[1] : o[2]);
          const float vc = c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
          return __fadd_rn(oc, __fmul_rn(vc, zt[p]));
        });
        hand_over(hand.pe_full);
      }
    }
  }
}

// The composite forward of a ray in f32 over the consumer threads, from the
// raw heads in hout (rgb | raw density, 4 a sample) and z: alpha and its
// prefix (alpha_prefix90, in scan0/scan1), trans = exp(prefix), wts = alpha
// trans, and hout's rgb turned into its sigmoid in place. With `sums` (5
// floats), each thread's partial sums over its samples of wts rgb (3),
// wts z and wts. Ends synchronised.
__device__ __forceinline__ void composite_fwd90(float* hout, const float* fz, float* alpha,
                                                float* trans, float* wts, float* scan0,
                                                float* scan1, int S, int occ_softplus,
                                                int head_dist_alpha, int dist_alpha,
                                                float* sums = nullptr) {
  const float* pre = alpha_prefix90(hout, fz, alpha, scan0, scan1, S, occ_softplus,
                                    head_dist_alpha, dist_alpha);
  for (int s = threadIdx.x; s < S; s += kConsumers) {
    const float tr = expf(pre[s]);
    const float w = alpha[s] * tr;
    trans[s] = tr;
    wts[s] = w;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rgb = 1.f / (1.f + expf(-hout[4 * s + c]));
      hout[4 * s + c] = rgb;
      if (sums != nullptr) sums[c] += w * rgb;
    }
    if (sums != nullptr) {
      sums[3] += w * fz[s];
      sums[4] += w;
    }
  }
  consumer_sync();
}

// The composite backward of a ray in f32 (the TPU kernel's _backward_tail):
// from the cotangents of the ray's rgb (g_rgb_ray[3]) and dist (gd) and,
// where not null, of its per-sample
// weights and alpha, g_w = g_rgb . rgb + gd z (- the sum of g_rgb with
// white_bg) [+ g_w_in], the exclusive suffix scan of g_w w, g_alpha and the
// dist_alpha g_delta terms, to graw (the raw density's cotangent), grgb
// (the raw rgb's, 4 a sample) and gz (dz's composite part). hout holds the
// sigmoid rgb | raw density, alpha, trans, wts the forward's; scan0, scan1
// are scratch of S floats. The last step (gz's dist_alpha terms, each
// thread its own samples) is left unsynchronised: the caller's next
// barrier orders it.
__device__ __forceinline__ void composite_bwd90(const float* g_rgb_ray, float gd, int white_bg,
                                                const float* g_w_in, const float* g_a_in,
                                                const float* hout, const float* fz,
                                                const float* alpha, const float* trans,
                                                const float* wts, float* scan0, float* scan1,
                                                float* graw, float* grgb, float* gz, int S,
                                                int occ_softplus, int head_dist_alpha,
                                                int dist_alpha) {
  const int tid = threadIdx.x;
  const float g_rgb_sum = g_rgb_ray[0] + g_rgb_ray[1] + g_rgb_ray[2];
  for (int s = tid; s < S; s += kConsumers) {
    float gw = g_rgb_ray[0] * hout[4 * s] + g_rgb_ray[1] * hout[4 * s + 1] +
               g_rgb_ray[2] * hout[4 * s + 2] + gd * fz[s];
    if (white_bg) gw -= g_rgb_sum;
    if (g_w_in != nullptr) gw += g_w_in[s];
    graw[s] = gw;                       // g_w, until g_raw replaces it below
    scan1[s] = gw * wts[s];             // g_c = g_trans * trans
  }
  consumer_sync();
  for (int s = tid; s < S; s += kConsumers) scan0[s] = s + 1 < S ? scan1[s + 1] : 0.f;
  consumer_sync();
  float* src = scan0;
  float* dst = scan1;
  for (int d = 1; d < S; d <<= 1) {
    for (int s = tid; s < S; s += kConsumers) dst[s] = s + d < S ? src[s] + src[s + d] : src[s];
    consumer_sync();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  for (int s = tid; s < S; s += kConsumers) {
    const float gw = graw[s], a = alpha[s], w = wts[s];
    float g_alpha = gw * trans[s] - src[s] / (1.f - a + kEps);
    if (g_a_in != nullptr) g_alpha += g_a_in[s];
    const float raw = hout[4 * s + 3];
    const float sigma = density_act(raw, occ_softplus);
    const float occ = head_dist_alpha ? sigma : 1.f - expf(-sigma);
    float g_occ = g_alpha, g_delta = 0.f;
    if (dist_alpha) {
      if (s == S - 1) {
        g_occ = 0.f;
      } else {
        const float delta = fz[s + 1] - fz[s];
        const float E = expf(-occ * delta);
        g_occ = g_alpha * delta * E;
        g_delta = g_alpha * occ * E;
      }
    }
    dst[s] = g_delta;
    const float g_sigma = head_dist_alpha ? g_occ : g_occ * (1.f - occ);
    const float g_raw =
        occ_softplus ? g_sigma * (1.f / (1.f + expf(-raw))) : (raw > 0.f ? g_sigma : 0.f);
    graw[s] = g_raw;
    gz[s] = gd * w;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rgb = hout[4 * s + c];
      grgb[4 * s + c] = w * g_rgb_ray[c] * rgb * (1.f - rgb);
    }
  }
  consumer_sync();
  if (dist_alpha) {
    for (int s = tid; s < S; s += kConsumers) gz[s] = gz[s] - dst[s] + (s > 0 ? dst[s - 1] : 0.f);
  }
}

// The tile's position-encoding cotangent (dpe, the m64n64 fragment of the
// warpgroup's rows) through the encoding to the ray: dz's encoding part into
// gz[p0 + m], d_o and d_v summed over the tile (per row, then the block in
// warp order) and added to rsum[0..5]. ray: o | v | dir. Ends synchronised.
__device__ __forceinline__ void tile_enc_vjp90(const float (&dpe)[32], const float* ray,
                                               const float* fz, float* gz, float* rsum,
                                               float* red, int p0) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  float sums[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // d_o xyz, d_v xyz
  float dzr[2] = {0.f, 0.f};
  const int m0 = 16 * warp;
#pragma unroll
  for (int hrow = 0; hrow < 2; ++hrow) {
    const int m = m0 + gq + 8 * hrow;
    const float zz = fz[p0 + m];
    float pts[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) pts[c] = __fadd_rn(ray[c], __fmul_rn(ray[3 + c], zz));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        int c;
        const float tv = enc_lane_grad90(dpe[4 * j + 2 * hrow + hc], pts, 8 * j + 2 * t + hc,
                                         10, &c);
        if (c >= 0) {
          dzr[hrow] += tv * ray[3 + c];
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) {
            if (c == cc) {
              sums[cc] += tv;
              sums[3 + cc] += tv * zz;
            }
          }
        }
      }
    }
    dzr[hrow] += __shfl_xor_sync(0xffffffffu, dzr[hrow], 1);
    dzr[hrow] += __shfl_xor_sync(0xffffffffu, dzr[hrow], 2);
    if (t == 0) gz[p0 + m] += dzr[hrow];
  }
  block_sum90<6>(sums, red);
  if (tid < 6) rsum[tid] += red[tid];
  consumer_sync();
}

// The direction encoding's cotangent, once per ray: w12 staged into `w12`
// (shared memory), dde = (sum_s bf16 g_h) wrde^T, pulled through the
// encoding to d(dir) into rsum[6..8]. Ends synchronised.
template <int D>
__device__ __forceinline__ void ray_dir_vjp90(unsigned char* w12, const unsigned char* w12_src,
                                              const float* ghsum, const float* ray, float* rsum,
                                              float* red) {
  constexpr int H = D / 2;
  const int tid = threadIdx.x;
  stage_w12<D>(w12, w12_src);
  consumer_sync();
  if (tid < kDe) {
    float dd = 0.f;
#pragma unroll 16
    for (int j = 0; j < H; ++j) {
      const bf16 wv = *reinterpret_cast<const bf16*>(w12 + swz(j, tid, 0));
      dd = fmaf(ghsum[j], __bfloat162float(wv), dd);
    }
    int c;
    red[tid] = enc_lane_grad(dd, ray + 6, tid, 4, &c);
    red[kDe + tid] = static_cast<float>(c);
  }
  consumer_sync();
  if (tid < 3) {
    float acc = 0.f;
    for (int k = 0; k < kDe; ++k)
      if (static_cast<int>(red[kDe + k]) == tid) acc += red[k];
    rsum[6 + tid] = acc;
  }
  consumer_sync();
}

}  // namespace
