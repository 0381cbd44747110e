// Point-query NeRF MLP backward on Hopper (sm_90a): K6, the VJP of
// point_mlp_fwd.cu's function with every weight and bias gradient, the
// forward recomputed per pass, on the wgmma dX chain of mlp_dx_sm90.cuh and
// the weight-gradient kernel of dw_sm90.cuh.
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_mlp.py::_bwd_kernel
// (reached through _raw_backward, the custom VJP of nerf_apply_fused)
// together with the head VJP and the encoding VJP that the JAX package runs
// around it in XLA (pallas_mlp.py:421-442). Inputs: the points and directions
// (M, 3) and the cotangents of the outputs, g_rgb (M, 3) and g_density (M, 1),
// f32. Outputs: dW (14 blocks, stored (in, out)) and dB (12) in the layout of
// nerf_bwd.cuh's grad_layout, d(points) (M, 3), d(directions) (M, 3).
//
// Numerics, the TPU kernel's (pallas_mlp.py:197-261): every cotangent rounded
// to bf16 before it enters a product (dX = g W^T, dW = x^T g), each dW formed
// from bf16 operands with f32 sums (`_dmat`), ReLU masks from the bf16
// activations, each dB summed from the masked f32 cotangents before their
// rounding; the encodings' cotangents pulled to the points and directions
// with the forward's own f32 sin/cos. d(points) and d(directions) are
// point_mlp_bwd_frozen.cu's, bit for bit: the same chain.
//
// Bound: compute. Forward + dX + dW are three products per layer, 3.56 MFLOP
// a point at D = 256, against 64 bytes of input and output a point and the
// weights and their gradients once. The operands the chain hands to the dW
// kernel (4.8 KB of X and 4.9 KB of G a point at D = 256, written once and
// read once) are the kernel's own choice and stay out of the bound.
//
// Design, three launches on one stream:
// 1. The chain, point_mlp_bwd_frozen.cu's kernel (persistent CTAs over
//    128-point passes; two consumer warpgroups on the wgmma trunk and dX
//    chain; a producer warpgroup streaming the weight slices and encoding
//    the next pass), which besides d(points) and d(directions) writes every
//    operand of a dW product to device memory, copied by each warpgroup from
//    its rows of shared memory once they are final: X = pe, x0..x7, feat, de
//    (the forward's activation buffer and encoding blocks) and G = g_h,
//    g_feat, g7..g0 (the bf16 cotangents the dX epilogues write over the
//    activations), in dw_sm90.cuh's tiled layout, one row tile per pass. The
//    dX epilogues also form the f32 column sums of the masked cotangents
//    (store_dx's SUM), summed per warpgroup in warp order into per-CTA bias
//    partials. The heads' rank-1 and rank-3 blocks stay here as scalar f32
//    sums: dW[9] = x7^T bf16(g_sigma) (x7 read back from its operand tile),
//    dW[13] = h^T bf16(g_rgb) (h read before g_h overwrites it), dB[8],
//    dB[10], dB[11]. g4 goes to dpe (after g0 W0) from its operand tile.
// 2. The chain's partials summed in CTA order (and warpgroup order) into the
//    gradient buffer.
// 3. dw_sm90.cuh on the work table below: the 12 other dW blocks.
// No float atomics anywhere: two launches give the same bits.
//
// Shared memory at D=256: point_mlp_bwd_frozen.cu's (activations 64 KB,
// encodings 32 KB, heads 6 KB, masks 34 KB, f32 arrays 5 KB, two 32 KB ring
// stages) and 8 KB of per-warp bias sums.

#include "dw_sm90.cuh"
#include "mlp_dx_sm90.cuh"

namespace {

// The dW kernel's operands of one pass, in device memory: X operands
// 0 pe, 1..8 x0..x7, 9 feat, 10 de; G operands 0 g_h, 1 g_feat, 2..9 g7..g0.
// Each operand is ceil(M/128) row tiles of its 64-column blocks, the
// operands one after the other.
template <int D>
struct Operands {
  __host__ __device__ static int xblocks(int i) { return i == 0 || i == 10 ? 1 : D / 64; }
  __host__ __device__ static int xbefore(int i) { return i == 0 ? 0 : 1 + (i - 1) * (D / 64); }
  __host__ __device__ static int gblocks(int i) { return i == 0 ? D / 128 : D / 64; }
  __host__ __device__ static int gbefore(int i) { return i == 0 ? 0 : D / 128 + (i - 1) * (D / 64); }
  static constexpr int kXBlocks = 2 + 9 * (D / 64);
  static constexpr int kGBlocks = D / 128 + 9 * (D / 64);
};

// A per-CTA, per-warpgroup segment of the chain's partial sums:
// [dW[9] (D) | the gradient buffer from dW[13] to the end of dB[11]].
__host__ __device__ inline int chain_seg(int D) {
  const GradLayout lay = grad_layout(D);
  return D + (lay.sums - lay.w[13]);
}

// The warpgroup's rows of `blocks` 64-column blocks, from shared memory to an
// operand tile in device memory (both swizzled, blocks kBlockBytes apart), by
// 16-byte copies past L1.
__device__ __forceinline__ void copy_rows(const unsigned char* src_wg, unsigned char* dst_wg,
                                          int blocks) {
  const int lt = threadIdx.x & 127;
  for (int e = lt; e < blocks * (kWgRowBytes / 16); e += 128) {
    const int blk = e / (kWgRowBytes / 16), off = (e % (kWgRowBytes / 16)) * 16;
    __stcg(reinterpret_cast<int4*>(dst_wg + blk * kBlockBytes + off),
           *reinterpret_cast<const int4*>(src_wg + blk * kBlockBytes + off));
  }
}

// The same rows by bulk copies (cp.async.bulk, shared to global) that one
// thread of the warpgroup issues and commits, so the warpgroup runs on while
// they drain; the smem rows must be fenced for the async proxy and the
// warpgroup synchronised before (every epilogue ends with that fence). Until
// bulk_drain, nothing may write over the rows.
__device__ __forceinline__ void copy_rows_async(const unsigned char* src_wg, unsigned char* dst_wg,
                                                int blocks) {
  if ((threadIdx.x & 127) != 0) return;
  for (int blk = 0; blk < blocks; ++blk)
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     dst_wg + blk * kBlockBytes),
                 "r"(smem_addr(src_wg + blk * kBlockBytes)), "r"(kWgRowBytes)
                 : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The issuing thread waits until its bulk copies have read shared memory.
__device__ __forceinline__ void bulk_drain() {
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The operand tiles of one pass: X operand i at x(i), G operand i at g(i).
template <int D>
struct PassTiles {
  unsigned char* xops;
  unsigned char* gops;
  size_t tile_bytes;   // one 64-column block over every pass
  long long pass;
  __device__ __forceinline__ unsigned char* x(int i) const {
    return xops + tile_bytes * Operands<D>::xbefore(i) + pass * Operands<D>::xblocks(i) * kBlockBytes;
  }
  __device__ __forceinline__ unsigned char* g(int i) const {
    return gops + tile_bytes * Operands<D>::gbefore(i) + pass * Operands<D>::gblocks(i) * kBlockBytes;
  }
};

// mlp_tile_masks' save hook: X operand i of this pass from its shared-memory
// buffer to its tile, by bulk copies; x7 (i = 8), which the kernel reads
// back for dW[9], by the warpgroup's own stores.
template <int D>
struct OperandSave {
  const unsigned char* act;
  const unsigned char* pe;
  const unsigned char* de;
  PassTiles<D> tiles;
  __device__ __forceinline__ void operator()(int i, int wg) const {
    const unsigned char* src = (i == 0 ? pe : (i == 10 ? de : act)) + wg * kWgRowBytes;
    unsigned char* dst = tiles.x(i) + wg * kWgRowBytes;
    if (i == 8)
      copy_rows(src, dst, Operands<D>::xblocks(i));
    else
      copy_rows_async(src, dst, Operands<D>::xblocks(i));
  }
  __device__ __forceinline__ void drain(int) const { bulk_drain(); }
};

// One dX layer (mlp_dx_sm90.cuh's dx_layer) that also writes the new bf16
// cotangent to its G tile (by bulk copies, or with SYNC by the warpgroup's
// stores) and adds its f32 column sums to bsum (this warpgroup's dB block):
// the four warps' sums in warp order.
template <int K, int N, bool MASK, bool RANK1, bool SYNC = false>
__device__ __forceinline__ void dx_layer_full(unsigned char* act_wg, uint32_t act_s, Ring& ring,
                                              const uint32_t* mask, const float* gs_wg,
                                              const unsigned char* dens_head,
                                              unsigned char* gtile_wg, float* bsum,
                                              float* red_wg) {
  const int wg = threadIdx.x >> 7;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  ring_products<N>(acc, act_s, K / 64, 4, ring);
  bulk_drain();   // the previous cotangent's copies have read the buffer
  wg_sync(wg);
  store_dx<N, MASK, RANK1, false, true>(acc, act_wg, mask, gs_wg, dens_head, nullptr, red_wg);
  wg_sync(wg);
  if (SYNC)
    copy_rows(act_wg, gtile_wg, N / 64);
  else
    copy_rows_async(act_wg, gtile_wg, N / 64);
  for (int c = threadIdx.x & 127; c < N; c += 128)
    bsum[c] += red_wg[c] + red_wg[N + c] + red_wg[2 * N + c] + red_wg[3 * N + c];
}

// The rgb head's backward (mlp_dx_sm90.cuh's rgb_head_bwd, the same g_h bits)
// with its gradients: thread (j = tid % H, row group tid / H) also sums over
// its rows the masked f32 g_h (dB[10]) and h[m][j] bf16(g_rgb[m][k]) (dW[13]),
// read before g_h goes over h; the row groups' sums are added in order, and
// dB[11], dB[8] are the tile's f32 sums of the raw-rgb and raw-density
// cotangents. part0: the CTA's first segment. Ends synchronised (both
// warpgroups) with the buffer fenced for wgmma.
template <int D>
__device__ __forceinline__ void rgb_head_bwd_full(unsigned char* act, const float* grgb,
                                                  const float* graw, const uint32_t* mask_h,
                                                  const unsigned char* rgb_head, float* red,
                                                  float* part0, const GradLayout& lay) {
  constexpr int H = D / 2;
  constexpr int NG = kConsumers / H;        // row groups, each of kPts / NG rows
  const int tid = threadIdx.x;
  const int j = tid % H, grp = tid / H;
  const float wo0 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(0, j, 1024)));
  const float wo1 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(1, j, 1024)));
  const float wo2 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(2, j, 1024)));
  float cs = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
  consumer_sync();   // both warpgroups are done with the buffer and the masks are in
#pragma unroll 8
  for (int m = grp * (kPts / NG); m < (grp + 1) * (kPts / NG); ++m) {
    const float g0 = bf16_round(grgb[4 * m]), g1 = bf16_round(grgb[4 * m + 1]),
                g2 = bf16_round(grgb[4 * m + 2]);
    bf16* cell = reinterpret_cast<bf16*>(act + swz(m, j, kBlockBytes));
    const float hv = __bfloat162float(*cell);
    float gh = g0 * wo0 + g1 * wo1 + g2 * wo2;
    if (!hidden_mask(mask_h, m, j)) gh = 0.f;
    *cell = __float2bfloat16_rn(gh);
    cs += gh;
    d0 += hv * g0;
    d1 += hv * g1;
    d2 += hv * g2;
  }
  fence_proxy_async();
  float* r = red + 4 * tid;
  r[0] = cs;
  r[1] = d0;
  r[2] = d1;
  r[3] = d2;
  consumer_sync();
  const int w13 = D, b0 = D + 3 * H;   // the segment's dW[13] and dB[0]
  if (tid < H) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] += red[4 * (gi * H + tid) + k];
    part0[b0 + lay.b[10] - lay.b[0] + tid] += v[0];
#pragma unroll
    for (int k = 0; k < 3; ++k) part0[w13 + 3 * tid + k] += v[1 + k];
  } else if (tid < H + 4) {   // dB[11] (3) and dB[8]: f32 sums over the tile
    const int k = tid - H;
    float acc = 0.f;
    if (k < 3) {
      for (int m = 0; m < kPts; ++m) acc += grgb[4 * m + k];
      part0[b0 + lay.b[11] - lay.b[0] + k] += acc;
    } else {
      for (int m = 0; m < kPts; ++m) acc += graw[m];
      part0[b0 + lay.b[8] - lay.b[0]] += acc;
    }
  }
  consumer_sync();
}

// The dX chain (mlp_dx_sm90.cuh's dx_chain, the same products in the same
// order) with every cotangent written to its G tile of `tiles` and its
// column sums added to the warpgroup's dB blocks (bb: its segment's dB[0]).
// g4 comes back for dpe from its tile.
template <int D>
__device__ __forceinline__ void dx_chain_full(float (&dpe)[32], unsigned char* act, Ring& ring,
                                              const uint32_t* masks, const float* gsbf,
                                              const unsigned char* dens_head,
                                              const PassTiles<D>& tiles, float* bb,
                                              float* red_wg, const GradLayout& lay) {
  constexpr int H = D / 2;
  constexpr int LW = mask_layer_words<D>();
  const int wg = threadIdx.x >> 7;
  unsigned char* act_g = act + wg * kWgRowBytes;
  const uint32_t act_s = smem_addr(act) + wg * kWgRowBytes;
  const float* gs_wg = gsbf + 64 * wg;
  auto g_wg = [&](int i) { return tiles.g(i) + wg * kWgRowBytes; };
  auto b_blk = [&](int i) { return bb + (lay.b[i] - lay.b[0]); };
  dx_layer_full<H, D, false, false>(act_g, act_s, ring, nullptr, nullptr, nullptr, g_wg(1),
                                    b_blk(9), red_wg);                       // g_feat
  dx_layer_full<D, D, true, true>(act_g, act_s, ring, masks + 7 * LW, gs_wg, dens_head, g_wg(2),
                                  b_blk(7), red_wg);                         // g7
#pragma unroll 1
  for (int l = 7; l >= 1; --l) {                                             // g6 .. g0
    if (l == 5)   // g4, read back below: the warpgroup's own stores
      dx_layer_full<D, D, true, false, true>(act_g, act_s, ring, masks + (l - 1) * LW, nullptr,
                                             nullptr, g_wg(10 - l), b_blk(l - 1), red_wg);
    else
      dx_layer_full<D, D, true, false>(act_g, act_s, ring, masks + (l - 1) * LW, nullptr,
                                       nullptr, g_wg(10 - l), b_blk(l - 1), red_wg);
  }
  __threadfence_block();   // g4's device-memory writes, before other threads read them back
#pragma unroll
  for (int i = 0; i < 32; ++i) dpe[i] = 0.f;
  ring_products<64>(dpe, act_s, D / 64, 4, ring);   // g0 W0
  bulk_drain();                                      // g0's copies have read the buffer
  wg_sync(wg);
  {  // g4 back over g0, by 16-byte cp.async
    const unsigned char* g4 = g_wg(5);
    constexpr int kChunks = (D / 64) * (kWgRowBytes / 16);
    const int lt = threadIdx.x & 127;
    for (int e = lt; e < kChunks; e += 128) {
      const int blk = e / (kWgRowBytes / 16), within = (e % (kWgRowBytes / 16)) * 16;
      const uint32_t dst = act_s + blk * kBlockBytes + within;
      const unsigned char* src = g4 + blk * kBlockBytes + within;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    fence_proxy_async();
  }
  wg_sync(wg);
  ring_products<64>(dpe, act_s, D / 64, 4, ring);   // + g4 W5pe
}

// f32 arrays: raw heads (128, 4), raw-rgb cotangents (128, 4), raw-density
// cotangents and their bf16 values (128 each), then the per-warp bias sums
// (2 warpgroups x 4 warps x D; the rgb head's 4 x 256 sums use them too).
template <int D>
constexpr size_t full_f32_bytes() {
  return sizeof(float) * (kPts * (4 + 4 + 1 + 1) + 8 * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads90, 1)
point_mlp_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                     const float* __restrict__ g_rgb, const float* __restrict__ g_density,
                     const unsigned char* __restrict__ tiles,
                     const unsigned char* __restrict__ tiles_dx, Biases bias,
                     unsigned char* xops, unsigned char* gops, float* chain_part,
                     float* __restrict__ dpts, float* __restrict__ ddirs, long long M,
                     int occ_softplus, int head_dist_alpha, Layout90<D> L) {
  using T = Tiles<D>;
  constexpr int H = D / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = setup90(smem_raw, L.bars, L.stages);
  Ring ring = make_ring(base, L.ring, L.bars, T::kFull, L.stages);
  const uint32_t head_bar = ring.full + 16 * kMaxStages;
  const uint32_t heads = smem_addr(base + L.heads);
  const Handoff hand = make_handoff(ring);
  const long long n_pass = (M + kPts - 1) / kPts;

  if (threadIdx.x >= kConsumers) {
    set_producer_regs();
    const int etid = threadIdx.x - kConsumers - 32;
    if (threadIdx.x == kConsumers) {
      const long long mine = (n_pass - blockIdx.x + gridDim.x - 1) / gridDim.x;
      mbar_expect_tx(head_bar, T::kDensHead + T::kRgbHead);
      bulk_load(heads, tiles + T::kHeads, T::kDensHead + T::kRgbHead, head_bar);
      Feeder f{ring};
      for (long long k = 0; k < mine; ++k) {
        f.forward<D>(tiles, T::kPoint);
        f.backward<D, true>(tiles_dx);
      }
    } else if (etid >= 0) {
      // encoders: point_mlp_fwd.cu's, the CTA's passes in order
      unsigned char* pe = base + L.pe;
      unsigned char* de = base + L.de;
      long long tile = 0;
      for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x, ++tile) {
        const long long p0 = pass * kPts;
        const int n = static_cast<int>(M - p0 < kPts ? M - p0 : kPts);
        wait_free(hand.pe_free, tile);
        encode_tile<10, kPe>(pe, etid, [&](int p, int c) {
          return p < n ? pts[3 * (p0 + p) + c] : 0.f;
        });
        hand_over(hand.pe_full);
        wait_free(hand.de_free, tile);
        encode_tile<4, kDe>(de, etid, [&](int p, int c) {
          return p < n ? dirs[3 * (p0 + p) + c] : 0.f;
        });
        hand_over(hand.de_full);
      }
    }
    return;
  }
  set_consumer_regs();

  const GradLayout lay = grad_layout(D);
  const int seg = chain_seg(D);
  float* hout = reinterpret_cast<float*>(base + L.f32 + mask_bytes<D>());   // (128, 4) raw
  float* grgb = hout + 4 * kPts;                          // raw-rgb cotangent     (128, 4)
  float* graw = grgb + 4 * kPts;                          // raw-density cotangent (128)
  float* gsbf = graw + kPts;                              // its bf16 value        (128)
  float* red = gsbf + kPts;                               // per-warp sums         (8, D)
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + L.f32);
  const uint32_t* mask_h = masks + 8 * mask_layer_words<D>();
  const unsigned char* dens_head = base + L.heads;
  const unsigned char* rgb_head = dens_head + T::kDensHead;
  const uint32_t pe_s = smem_addr(base + L.pe), de_s = smem_addr(base + L.de);
  const uint32_t act_s = smem_addr(base + L.act) + (threadIdx.x >> 7) * kWgRowBytes;
  const int tid = threadIdx.x, wg = tid >> 7;
  float* part0 = chain_part + static_cast<size_t>(blockIdx.x) * 2 * seg;   // CTA-wide sums
  float* part_wg = part0 + wg * seg;                                         // this warpgroup's
  for (int e = tid; e < 2 * seg; e += kConsumers) part0[e] = 0.f;
  __threadfence_block();
  OperandSave<D> save;
  save.act = base + L.act;
  save.pe = base + L.pe;
  save.de = base + L.de;
  save.tiles = PassTiles<D>{xops, gops, static_cast<size_t>(n_pass) * kBlockBytes, 0};
  mbar_wait(head_bar, 0);

  long long tile = 0;
  for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x, ++tile) {
    const long long p0 = pass * kPts;
    const int n = static_cast<int>(M - p0 < kPts ? M - p0 : kPts);
    save.tiles.pass = pass;
    mlp_tile_masks<D>(bias.b, pe_s, de_s, base + L.act, heads, heads + T::kDensHead, bias.b[10],
                      hout, hand, tile, ring, masks, save);
    __threadfence_block();   // the operand tiles (x7's below) before other threads read them
    consumer_sync();         // both warpgroups' raw heads are in

    // ---- head VJP (f32); rows of a ragged pass get zero cotangents -------------
    if (tid < kPts) {
      const bool live = tid < n;
      const float raw = hout[4 * tid + 3];
      const float gd = live ? g_density[p0 + tid] : 0.f;
      const float sigma = density_act(raw, occ_softplus);
      const float g_sigma = head_dist_alpha ? gd : gd * expf(-sigma);
      const float gr =
          occ_softplus ? g_sigma * (1.f / (1.f + expf(-raw))) : (raw > 0.f ? g_sigma : 0.f);
      graw[tid] = gr;
      gsbf[tid] = bf16_round(gr);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float s = 1.f / (1.f + expf(-hout[4 * tid + k]));
        grgb[4 * tid + k] = (live ? g_rgb[3 * (p0 + tid) + k] : 0.f) * (s * (1.f - s));
      }
    }
    rgb_head_bwd_full<D>(base + L.act, grgb, graw, mask_h, rgb_head, red, part0, lay);
    copy_rows_async(base + L.act + wg * kWgRowBytes, save.tiles.g(0) + wg * kWgRowBytes,
                    H / 64);   // g_h
    if (tid < D) {   // dW[9] = x7^T bf16(g_sigma), x7 from its operand tile
      const unsigned char* x7 = save.tiles.x(8);
      float acc = 0.f;
#pragma unroll 8
      for (int m = 0; m < kPts; ++m)
        acc += __bfloat162float(__ushort_as_bfloat16(__ldcg(
                   reinterpret_cast<const unsigned short*>(x7 + swz(m, tid, kBlockBytes))))) *
               gsbf[m];
      part0[tid] += acc;
    }

    {  // d(directions) = (g_h wrde^T) through the direction encoding, per point
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      ring_products<32>(acc, act_s, H / 64, 4, ring);
      coord_grad90<4>(acc, dirs, 4, n, p0, ddirs);
    }
    float dpe[32];
    dx_chain_full<D>(dpe, base + L.act, ring, masks, gsbf, dens_head, save.tiles,
                     part_wg + D + 3 * H, red + wg * 4 * D, lay);
    coord_grad90<8>(dpe, pts, 10, n, p0, dpts);
  }
  // every bulk copy of the CTA's operands has completed before it exits
  if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// grads' dW[9] and dW[13]..dB[11] = the chain's segments summed in order
// (CTA, then warpgroup).
__global__ void chain_reduce_kernel(const float* __restrict__ part, float* __restrict__ grads,
                                    int seg, int n_seg, int D) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= seg) return;
  float acc = 0.f;
  for (int s = 0; s < n_seg; ++s) acc += part[static_cast<size_t>(s) * seg + e];
  const GradLayout lay = grad_layout(D);
  grads[e < D ? lay.w[9] + e : lay.w[13] + (e - D)] = acc;
}

// dw_sm90.cuh's work table of K6: the 12 dW blocks past the heads, each
// (pack_weights index, X operand, G operand, K, N).
template <int D>
DwTable point_dw_table(const unsigned char* xops, const unsigned char* gops, float* grads,
                       long long n_pass) {
  using O = Operands<D>;
  constexpr int H = D / 2;
  const GradLayout lay = grad_layout(D);
  const int rows[12][5] = {{0, 0, 9, 64, D},  {1, 1, 8, D, D},  {2, 2, 7, D, D},
                           {3, 3, 6, D, D},   {4, 4, 5, D, D},  {5, 0, 5, 64, D},
                           {6, 5, 4, D, D},   {7, 6, 3, D, D},  {8, 7, 2, D, D},
                           {10, 8, 1, D, D},  {11, 9, 0, D, H}, {12, 10, 0, 32, H}};
  const size_t tile_bytes = static_cast<size_t>(n_pass) * kBlockBytes;
  DwTable tab;
  tab.n = 12;
  for (int i = 0; i < 12; ++i) {
    DwBlock& b = tab.b[i];
    b.x = xops + tile_bytes * O::xbefore(rows[i][1]);
    b.g = gops + tile_bytes * O::gbefore(rows[i][2]);
    b.xblocks = O::xblocks(rows[i][1]);
    b.gblocks = O::gblocks(rows[i][2]);
    b.K = rows[i][3];
    b.N = rows[i][4];
    b.dst = grads + lay.w[rows[i][0]];
  }
  return tab;
}

template <int D>
cudaError_t launch_bwd(const float* pts, const float* dirs, const float* g_rgb,
                       const float* g_density, const unsigned char* tiles,
                       const unsigned char* tiles_dx, const Biases& bias, unsigned char* xops,
                       unsigned char* gops, float* chain_part, float* dw_part, float* grads,
                       float* dpts, float* ddirs, long long M, int n_ctas, int chunks,
                       int occ_softplus, int head_dist_alpha, cudaStream_t stream) {
  const size_t area = mask_bytes<D>() + full_f32_bytes<D>();   // masks, then the f32 arrays
  const Layout90<D> L(true, area);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = L.bytes(area);
  cudaError_t err = cudaFuncSetAttribute(point_mlp_bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  point_mlp_bwd_kernel<D><<<n_ctas, kThreads90, smem, stream>>>(
      pts, dirs, g_rgb, g_density, tiles, tiles_dx, bias, xops, gops, chain_part, dpts, ddirs, M,
      occ_softplus, head_dist_alpha, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int seg = chain_seg(D);
  chain_reduce_kernel<<<(seg + 255) / 256, 256, 0, stream>>>(chain_part, grads, seg, 2 * n_ctas, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  DwTable tab = point_dw_table<D>(xops, gops, grads, (M + kPts - 1) / kPts);
  return dw_sm90_launch(tab, M, chunks, dw_part, stream);
}

template <int D>
void scratch_sizes(long long M, int n_ctas, long long* sizes) {
  using O = Operands<D>;
  const long long n_pass = (M + kPts - 1) / kPts;
  sizes[0] = n_pass * kBlockBytes * O::kXBlocks;
  sizes[1] = n_pass * kBlockBytes * O::kGBlocks;
  sizes[2] = 4ll * n_ctas * 2 * chain_seg(D);
  long long kn = 0;
  DwTable tab = point_dw_table<D>(nullptr, nullptr, nullptr, n_pass);
  for (int i = 0; i < tab.n; ++i) kn += static_cast<long long>(tab.b[i].K) * tab.b[i].N;
  sizes[3] = 4ll * kn;
  int tiles = 0;
  for (int i = 0; i < tab.n; ++i) tiles += (tab.b[i].K + 127) / 128;
  sizes[4] = tiles;
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

// Bytes of nerf_point_mlp_bwd's scratch buffers into sizes[0..3]: the X and
// G operands, the chain's partial sums, the dW kernel's partials per chunk of
// points; and the dW kernel's CTA tiles into sizes[4], from which the caller
// picks the chunks. Returns 0, or cudaErrorInvalidValue for a width the
// kernel is not built for.
extern "C" int nerf_point_mlp_bwd_scratch(int D, long long M, int n_ctas, long long* sizes) {
  if (D == 256)
    scratch_sizes<256>(M, n_ctas, sizes);
  else if (D == 128)
    scratch_sizes<128>(M, n_ctas, sizes);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// pts, dirs, g_rgb (M, 3) and g_density (M, 1) f32, contiguous on the device;
// tiles: pack_tiles' forward weight buffer, tiles_dx: pack_tiles_dx's
// backward buffer (both 16-byte aligned); biases: 12 f32 device pointers in
// the Net layout. xops, gops, chain_part, dw_part: scratch of the sizes
// nerf_point_mlp_bwd_scratch gives (dw_part: chunks times its size; all
// 16-byte aligned). grads: total f32 (out),
// dpts, ddirs (M, 3) f32 (out). 0 < n_ctas <= the number of 128-point passes,
// 0 < chunks <= the same. Returns a cudaError_t (0 on success); the launches
// are asynchronous on `stream`.
extern "C" int nerf_point_mlp_bwd(const float* pts, const float* dirs, const float* g_rgb,
                                  const float* g_density, const void* tiles, const void* tiles_dx,
                                  const void* const* biases, void* xops, void* gops,
                                  float* chain_part, float* dw_part, float* grads, float* dpts,
                                  float* ddirs, long long M, int D, int n_ctas, int chunks,
                                  int occ_softplus, int head_dist_alpha, int total, void* stream) {
  const long long n_pass = (M + kPts - 1) / kPts;
  if (M <= 0 || n_ctas <= 0 || n_ctas > n_pass || chunks <= 0 || chunks > n_pass)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((D != 128 && D != 256) || total != grad_layout(D).total)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(tiles) | reinterpret_cast<uintptr_t>(tiles_dx) |
       reinterpret_cast<uintptr_t>(xops) | reinterpret_cast<uintptr_t>(gops)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Biases bias;
  for (int i = 0; i < 12; ++i) bias.b[i] = static_cast<const float*>(biases[i]);
  const auto* w = static_cast<const unsigned char*>(tiles);
  const auto* wdx = static_cast<const unsigned char*>(tiles_dx);
  auto* xo = static_cast<unsigned char*>(xops);
  auto* go = static_cast<unsigned char*>(gops);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = D == 256
      ? launch_bwd<256>(pts, dirs, g_rgb, g_density, w, wdx, bias, xo, go, chain_part, dw_part,
                        grads, dpts, ddirs, M, n_ctas, chunks, occ_softplus, head_dist_alpha, st)
      : launch_bwd<128>(pts, dirs, g_rgb, g_density, w, wdx, bias, xo, go, chain_part, dw_part,
                        grads, dpts, ddirs, M, n_ctas, chunks, occ_softplus, head_dist_alpha, st);
  return static_cast<int>(err);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
