// The hand-off from the wgmma dX chain to the weight-gradient kernel on
// Hopper (sm_90a), shared by the backward kernels that form every weight
// gradient: point_mlp_bwd.cu and point_mlp_bwd_xwide.cu (K6 full) and
// render_full_sm90.cuh (K1, the render train step, and K4 full, the render
// backward).
//
// The chain of mlp_dx_sm90.cuh forms no weight gradient. These pieces make
// it hand over what the dW products need:
// - the X operands (pe, x0..x7, feat and, for K6, de), saved by the
//   forward's save hook (OperandSave) from the shared-memory buffers they
//   live in, and the G operands (g_h, g_feat, g7..g0), saved by the dX
//   layers (dx_layer_full, dx_chain_full) right after their epilogues, all in
//   dw_sm90.cuh's tiled layout, one row tile per 128-point pass;
// - the bias gradients, summed in the dX epilogues (store_dx's SUM) per
//   warpgroup in warp order into a per-CTA, per-warpgroup segment of partial
//   sums in device memory, with the head blocks that stay in the chain
//   (dW[9], dW[13], dB[8], dB[10], dB[11]; rgb_head_bwd_full), summed at the
//   end in CTA and warpgroup order (chain_reduce_kernel);
// - the work table of dw_sm90.cuh over those operands (chain_dw_pieces, chain_dw_launch).
// At hidden_dim 384 and 512 the same hand-off runs on the 64-point chain of
// mlp_dx_wide_sm90.cuh (OperandSaveW and the heads below it; K6 full, and with
// RENDER the render kernels, whose segment starts at dW[12]); at 640 to 1024
// on mlp_dx_xwide_sm90.cuh's chain in passes of 128 columns (OperandSaveX and
// rgb_head_bwd_x_full; K6 full, and with RENDER the render kernels).
// No float atomics: two launches give the same bits.

#pragma once

#include "dw_sm90.cuh"
#include "mlp_dx_sm90.cuh"
#include "mlp_dx_wide_sm90.cuh"
#include "mlp_dx_xwide_sm90.cuh"

namespace {

// The dW kernel's operands of one pass, in device memory: X operands
// 0 pe, 1..8 x0..x7, 9 feat, 10 de; G operands 0 g_h, 1 g_feat, 2..9 g7..g0.
// Each operand is ceil(M/128) row tiles of its 64-column blocks, the
// operands one after the other. The render kernels, which fold the direction
// product into a per-ray bias, keep no de: their X operands stop at feat.
template <int D>
struct Operands {
  __host__ __device__ static int xblocks(int i) { return i == 0 || i == 10 ? 1 : D / 64; }
  __host__ __device__ static int xbefore(int i) { return i == 0 ? 0 : 1 + (i - 1) * (D / 64); }
  __host__ __device__ static int gblocks(int i) { return i == 0 ? D / 128 : D / 64; }
  __host__ __device__ static int gbefore(int i) { return i == 0 ? 0 : D / 128 + (i - 1) * (D / 64); }
  __host__ __device__ static int xtotal(bool de) { return 1 + 9 * (D / 64) + (de ? 1 : 0); }
  static constexpr int kGBlocks = D / 128 + 9 * (D / 64);
};

// A per-CTA, per-warpgroup segment of a chain's partial sums: dW[9] (D),
// then the gradient buffer from float `from` to float `to` (K6: dW[13] to
// the end of dB[11]; the render kernels: dW[12] to the end of the loss sums).
__host__ __device__ inline int chain_seg(int D, int from, int to) { return D + (to - from); }

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

// Every bulk copy of the warpgroup has completed (before the CTA exits).
__device__ __forceinline__ void bulk_complete() {
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
// buffer to its tile, by bulk copies; x7 (i = 8), which the kernels read
// back for dW[9], by the warpgroup's own stores. `de` may be null where no
// direction block is saved (the render kernels).
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
// cotangents. w13, b0: the CTA's first segment's dW[13] and dB[0]. With
// GHSUM (the render kernels) each thread also sums its rows' bf16 g_h and
// ghsum[j] += the row groups' sums in order, as rgb_head_bwd does; red then
// holds 5 floats a consumer thread, else 4. Ends synchronised (both
// warpgroups) with the buffer fenced for wgmma.
template <int D, bool GHSUM = false>
__device__ __forceinline__ void rgb_head_bwd_full(unsigned char* act, const float* grgb,
                                                  const float* graw, const uint32_t* mask_h,
                                                  const unsigned char* rgb_head, float* red,
                                                  float* w13, float* b0, const GradLayout& lay,
                                                  float* ghsum = nullptr) {
  constexpr int H = D / 2;
  constexpr int NG = kConsumers / H;        // row groups, each of kPts / NG rows
  constexpr int R = GHSUM ? 5 : 4;
  const int tid = threadIdx.x;
  const int j = tid % H, grp = tid / H;
  const float wo0 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(0, j, 1024)));
  const float wo1 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(1, j, 1024)));
  const float wo2 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(2, j, 1024)));
  float cs = 0.f, csb = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
  consumer_sync();   // both warpgroups are done with the buffer and the masks are in
#pragma unroll 8
  for (int m = grp * (kPts / NG); m < (grp + 1) * (kPts / NG); ++m) {
    const float g0 = bf16_round(grgb[4 * m]), g1 = bf16_round(grgb[4 * m + 1]),
                g2 = bf16_round(grgb[4 * m + 2]);
    bf16* cell = reinterpret_cast<bf16*>(act + swz(m, j, kBlockBytes));
    const float hv = __bfloat162float(*cell);
    float gh = g0 * wo0 + g1 * wo1 + g2 * wo2;
    if (!hidden_mask(mask_h, m, j)) gh = 0.f;
    const bf16 ghb = __float2bfloat16_rn(gh);
    *cell = ghb;
    cs += gh;
    if (GHSUM) csb += __bfloat162float(ghb);
    d0 += hv * g0;
    d1 += hv * g1;
    d2 += hv * g2;
  }
  fence_proxy_async();
  float* r = red + R * tid;
  r[0] = cs;
  r[1] = d0;
  r[2] = d1;
  r[3] = d2;
  if (GHSUM) r[4] = csb;
  consumer_sync();
  if (tid < H) {
    float v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = 0.f;
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] += red[R * (gi * H + tid) + k];
    b0[lay.b[10] - lay.b[0] + tid] += v[0];
#pragma unroll
    for (int k = 0; k < 3; ++k) w13[3 * tid + k] += v[1 + k];
    if (GHSUM) ghsum[tid] += v[4];
  } else if (tid < H + 4) {   // dB[11] (3) and dB[8]: f32 sums over the tile
    const int k = tid - H;
    float acc = 0.f;
    if (k < 3) {
      for (int m = 0; m < kPts; ++m) acc += grgb[4 * m + k];
      b0[lay.b[11] - lay.b[0] + k] += acc;
    } else {
      for (int m = 0; m < kPts; ++m) acc += graw[m];
      b0[lay.b[8] - lay.b[0]] += acc;
    }
  }
  consumer_sync();
}

// dW[9] += x7^T bf16(g_sigma) over the pass (tid < D): x7 read back from its
// operand tile, gsbf the bf16-valued raw-density cotangents (128 f32).
template <int D>
__device__ __forceinline__ void density_head_dw(const PassTiles<D>& tiles, const float* gsbf,
                                                float* w9) {
  const int tid = threadIdx.x;
  if (tid >= D) return;
  const unsigned char* x7 = tiles.x(8);
  float acc = 0.f;
#pragma unroll 8
  for (int m = 0; m < kPts; ++m)
    acc += __bfloat162float(__ushort_as_bfloat16(__ldcg(
               reinterpret_cast<const unsigned short*>(x7 + swz(m, tid, kBlockBytes))))) *
           gsbf[m];
  w9[tid] += acc;
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

// grads' dW[9] and floats from..from+seg-D = the chain's segments summed in
// order (CTA, then warpgroup); with `add`, that sum added to what they hold
// (the render kernels' later chunks of rays).
__global__ void chain_reduce_kernel(const float* __restrict__ part, float* __restrict__ grads,
                                    int seg, int n_seg, int D, int from, int add) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= seg) return;
  float acc = 0.f;
  for (int s = 0; s < n_seg; ++s) acc += part[static_cast<size_t>(s) * seg + e];
  const GradLayout lay = grad_layout(D);
  float* dst = grads + (e < D ? lay.w[9] + e : from + (e - D));
  *dst = add ? *dst + acc : acc;
}

inline cudaError_t chain_reduce_launch(const float* part, float* grads, int seg, int n_ctas,
                                       int D, int from, cudaStream_t stream, bool add = false) {
  chain_reduce_kernel<<<(seg + 255) / 256, 256, 0, stream>>>(part, grads, seg, 2 * n_ctas, D,
                                                              from, add ? 1 : 0);
  return cudaGetLastError();
}

// dw_sm90.cuh's work table of the dW blocks past the heads over a chain's
// operands, each (pack_weights index, X operand, G operand, K, N): K6's 12,
// or, without the direction block (dW[12] = de^T g_h, which the render
// kernels form per ray), the render kernels' first 11. A block wider than the
// dW kernel's 256 columns (from hidden_dim 384 on) goes in column pieces of
// 256, then 128, then 64 (ops/fused_mlp.py::point_dw_pieces): 24 pieces at
// 384, 22 at 512, 34 at 640 and 768, 46 at 896, 44 at 1024 (the render
// kernels' table: 22 and 21 at 384 and 512, fused_mlp.render_dw_pieces); at
// 128 and 256 every block is one piece. One launch of the dW kernel takes at
// most kDwMaxBlocks pieces, so past 512 the table goes in two launches
// (chain_dw_launch).
constexpr int kChainMaxPieces = 48;

struct ChainPieces {
  DwBlock b[kChainMaxPieces];
  int n;
};

template <int D>
ChainPieces chain_dw_pieces(const unsigned char* xops, const unsigned char* gops, float* grads,
                            long long n_pass, bool de) {
  using O = Operands<D>;
  constexpr int H = D / 2;
  const GradLayout lay = grad_layout(D);
  const int rows[12][5] = {{0, 0, 9, 64, D},  {1, 1, 8, D, D},  {2, 2, 7, D, D},
                           {3, 3, 6, D, D},   {4, 4, 5, D, D},  {5, 0, 5, 64, D},
                           {6, 5, 4, D, D},   {7, 6, 3, D, D},  {8, 7, 2, D, D},
                           {10, 8, 1, D, D},  {11, 9, 0, D, H}, {12, 10, 0, 32, H}};
  const size_t tile_bytes = static_cast<size_t>(n_pass) * kBlockBytes;
  ChainPieces tab;
  tab.n = 0;
  for (int i = 0; i < (de ? 12 : 11); ++i) {
    for (int c0 = 0; c0 < rows[i][4];) {
      const int rest = rows[i][4] - c0;
      const int n = rest >= 256 ? 256 : (rest >= 128 ? 128 : 64);
      DwBlock& b = tab.b[tab.n++];
      b.x = xops + tile_bytes * O::xbefore(rows[i][1]);
      b.g = gops + tile_bytes * O::gbefore(rows[i][2]) + (c0 / 64) * kBlockBytes;
      b.xblocks = O::xblocks(rows[i][1]);
      b.gblocks = n / 64;
      b.gstride = O::gblocks(rows[i][2]);
      b.K = rows[i][3];
      b.N = n;
      b.ldd = rows[i][4];
      b.dst = grads + lay.w[rows[i][0]] + c0;
      c0 += n;
    }
  }
  return tab;
}

// The dW kernel over a chain's table on `stream`: consecutive launches of at
// most kDwMaxBlocks pieces in table order, each with the same `chunks` of
// the M rows (n_pass row tiles), with `add` (dw_sm90_launch's). A piece's
// sum depends only on the chunk split, never on the launch it goes in, so
// how the table is cut moves no bit. The launches reuse dw_part one after
// another. A non-null `launched` is raised by one for each launch made.
template <int D>
cudaError_t chain_dw_launch(const unsigned char* xops, const unsigned char* gops, float* grads,
                            long long n_pass, bool de, long long M, int chunks, float* dw_part,
                            cudaStream_t stream, bool add = false, int* launched = nullptr) {
  const ChainPieces all = chain_dw_pieces<D>(xops, gops, grads, n_pass, de);
  for (int first = 0; first < all.n; first += kDwMaxBlocks) {
    DwTable tab;
    tab.n = all.n - first < kDwMaxBlocks ? all.n - first : kDwMaxBlocks;
    for (int i = 0; i < tab.n; ++i) tab.b[i] = all.b[first + i];
    const cudaError_t err = dw_sm90_launch(tab, M, chunks, dw_part, stream, add);
    if (err != cudaSuccess) return err;
    if (launched != nullptr) ++*launched;
  }
  return cudaSuccess;
}

// Bytes of a chain's scratch into sizes[0..3] (the X and G operands of
// n_pass passes, the chain's partial sums for n_ctas CTAs of segments of
// `seg` floats, the dW kernel's partials per chunk of points, for every
// piece of the table) and the dW kernel's CTA tiles over the whole table
// into sizes[4].
template <int D>
void chain_scratch_sizes(long long n_pass, int n_ctas, int seg, bool de, long long* sizes) {
  using O = Operands<D>;
  sizes[0] = n_pass * kBlockBytes * O::xtotal(de);
  sizes[1] = n_pass * kBlockBytes * O::kGBlocks;
  sizes[2] = 4ll * n_ctas * 2 * seg;
  long long kn = 0;
  int tiles = 0;
  const ChainPieces tab = chain_dw_pieces<D>(nullptr, nullptr, nullptr, n_pass, de);
  for (int i = 0; i < tab.n; ++i) {
    kn += static_cast<long long>(tab.b[i].K) * tab.b[i].N;
    tiles += (tab.b[i].K + 127) / 128;
  }
  sizes[3] = 4ll * kn;
  sizes[4] = tiles;
}

// ---- hidden_dim 384 and 512: the hand-off from the 64-point chain ----------------
//
// The wide chain's tile is 64 points, the dW kernel's row tile 128: pass t
// writes half t % 2 of row tile t / 2 of each operand. A 64-column block of a
// wide buffer (64 rows, kWBlockBytes) and one of a row tile (128 rows,
// kBlockBytes) share the 128-byte swizzle, whose pattern repeats every 8
// rows, so a block goes to its row tile as one contiguous 8 KB copy,
// kWBlockBytes into the block for the second half. Where M % 128 is 1 to 64
// the last row tile's second half is never written: the dW kernel reads rows
// past M as zero (dw_consume).

// The operand tiles of one 64-point pass: X operand i's 64-column block j at
// x(i) + j kBlockBytes (PassTiles' operands).
template <int D>
struct PassTilesW {
  unsigned char* xops;
  unsigned char* gops;
  size_t tile_bytes;   // one 64-column block over every row tile
  long long pass;
  __device__ __forceinline__ unsigned char* x(int i) const {
    return xops + tile_bytes * Operands<D>::xbefore(i) +
           (pass >> 1) * Operands<D>::xblocks(i) * kBlockBytes + (pass & 1) * kWBlockBytes;
  }
  __device__ __forceinline__ unsigned char* g(int i) const {
    return gops + tile_bytes * Operands<D>::gbefore(i) +
           (pass >> 1) * Operands<D>::gblocks(i) * kBlockBytes + (pass & 1) * kWBlockBytes;
  }
};

// `blocks` 64-column blocks of a wide buffer (generic pointer to the first;
// kWBlockBytes apart) to their place in a row tile (kBlockBytes apart), by
// bulk copies that the warpgroup's first thread issues and commits
// (copy_rows_async's rules: the rows fenced for the async proxy and the
// warpgroup synchronised before; nothing writes over them until bulk_drain).
__device__ __forceinline__ void copy_blocks_w_async(const unsigned char* src, unsigned char* dst,
                                                    int blocks) {
  if ((threadIdx.x & 127) != 0) return;
  for (int blk = 0; blk < blocks; ++blk)
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     dst + static_cast<size_t>(blk) * kBlockBytes),
                 "r"(smem_addr(src + blk * kWBlockBytes)), "r"(kWBlockBytes)
                 : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The same by the warpgroup's own 16-byte stores past L1.
__device__ __forceinline__ void copy_blocks_w(const unsigned char* src, unsigned char* dst,
                                              int blocks) {
  for (int e = threadIdx.x & 127; e < blocks * (kWBlockBytes / 16); e += 128) {
    const int blk = e / (kWBlockBytes / 16), off = (e % (kWBlockBytes / 16)) * 16;
    __stcg(reinterpret_cast<int4*>(dst + static_cast<size_t>(blk) * kBlockBytes + off),
           *reinterpret_cast<const int4*>(src + blk * kWBlockBytes + off));
  }
}

// A CTA's per-warp column sums in device memory: two buffers (one layer's,
// the next layer's) x 2 warpgroups x 4 warps x D/2 floats. The rgb head's
// backward takes all of it: 4 sums x 4 warps x D/4 floats a warpgroup; with
// RENDER, 5 sums, which take red_bytes_w<D, true>'s 10 D floats.
template <int D, bool RENDER = false>
__host__ __device__ constexpr size_t red_bytes_w() { return sizeof(float) * (RENDER ? 10 : 8) * D; }

// mlp_tile_w_masks' and dx_chain_w's hook in K6 full at 384 and 512. Each
// warpgroup saves the 64-column blocks it wrote (its D/2 columns of a layer),
// since it is the one that writes over them next; pe and de (one block each)
// go by warpgroup 0, and so does g_h (D/2 columns from both warpgroups, all of
// which warpgroup 0 writes over in g7). Bulk copies, but x7 (X operand 8),
// which the chain reads back for dW[9], by the warpgroup's own stores. grad(i)
// also sums the layer's bias gradient: its four warps' column sums from
// red_at(i) in warp order, added to the warpgroup's segment (chain_seg:
// dW[9], then the gradient buffer from dW[13] to the end of dB[11]; with
// RENDER, the render kernels', from dW[12] to the end of the loss sums).
template <int D, bool RENDER = false>
struct OperandSaveW {
  static constexpr bool kSum = true;
  static constexpr int kBlocks = D / 128;   // a warpgroup's 64-column blocks of a layer
  PassTilesW<D> tiles;
  float* red;    // the CTA's column sums (red_bytes_w)
  float* part;   // the CTA's two segments, warpgroup 0's first
  int seg;       // floats of a segment
  __device__ __forceinline__ void operator()(int i, int wg, const unsigned char* src) const {
    if (i == 0 || i == 10) {
      if (wg == 0) copy_blocks_w_async(src, tiles.x(i), 1);
      return;
    }
    const unsigned char* s = src + wg * kBlocks * kWBlockBytes;
    unsigned char* d = tiles.x(i) + wg * kBlocks * kBlockBytes;
    if (i == 8)
      copy_blocks_w(s, d, kBlocks);
    else
      copy_blocks_w_async(s, d, kBlocks);
  }
  __device__ __forceinline__ void grad(int i, int wg, const unsigned char* src) const {
    if (i == 0) {
      if (wg == 0) copy_blocks_w_async(src, tiles.g(0), kBlocks);
      return;
    }
    copy_blocks_w_async(src + wg * kBlocks * kWBlockBytes,
                        tiles.g(i) + wg * kBlocks * kBlockBytes, kBlocks);
    constexpr int N = D / 2;
    const GradLayout lay = grad_layout(D);
    const int k = i == 1 ? 9 : 9 - i;   // the layer's dB block: g_feat's 9, g_l's l
    const float* r = red_at(i, wg);
    float* b = part + wg * seg + D + (lay.b[0] - (RENDER ? lay.w[12] : lay.w[13])) +
               (k == 9 ? lay.b[9] - lay.b[0] : k * D) + wg * N;
    for (int c = threadIdx.x & 127; c < N; c += 128)
      b[c] += ((__ldcg(r + c) + __ldcg(r + N + c)) + __ldcg(r + 2 * N + c)) + __ldcg(r + 3 * N + c);
  }
  __device__ __forceinline__ void drain(int) const { bulk_drain(); }
  __device__ __forceinline__ float* red_at(int i, int wg) const {
    return red + ((i & 1) * 2 + wg) * 4 * (D / 2);
  }
};

// h's two bf16 under a thread's cell of a buffer parked in device memory, past L1.
__device__ __forceinline__ __nv_bfloat162 ldcg_bf162(const unsigned char* p) {
  const unsigned int u = __ldcg(reinterpret_cast<const unsigned int*>(p));
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// ---- hidden_dim 640 to 1024: the hand-off from mlp_dx_xwide_sm90.cuh's chain ------
//
// The chain's tile is 64 points, as at 384 and 512, so a pass writes half
// pass % 2 of each operand's 128-row tile (PassTilesW). What differs is who
// writes which columns: a D-wide layer runs in D/128 passes of 128 columns,
// and in pass p warpgroup g writes columns [128p + 64g, 128p + 64g + 64), the
// 64-column block 2p + g. The hook is called once a layer is whole in the
// buffer (after layer_end_with's last barrier), and each warpgroup drains its
// copies before the next write over the buffer (layer_end_with drains, then
// synchronises), so any split of the copies between the warpgroups would do:
// each copies the blocks it wrote.

// The blocks wg, wg + 2, ..., of `blocks` of them (generic pointer to block
// 0 of a 64-row buffer; kWBlockBytes apart) to their place in a row tile
// (kBlockBytes apart): copy_blocks_w_async's rules, by bulk copies.
__device__ __forceinline__ void copy_own_blocks_x_async(const unsigned char* src,
                                                        unsigned char* dst, int wg, int blocks) {
  if ((threadIdx.x & 127) != 0) return;
  for (int k = 0; k < blocks; ++k) {
    const int blk = 2 * k + wg;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     dst + static_cast<size_t>(blk) * kBlockBytes),
                 "r"(smem_addr(src + blk * kWBlockBytes)), "r"(kWBlockBytes)
                 : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The same by the warpgroup's own 16-byte stores past L1.
__device__ __forceinline__ void copy_own_blocks_x(const unsigned char* src, unsigned char* dst,
                                                  int wg, int blocks) {
  for (int e = threadIdx.x & 127; e < blocks * (kWBlockBytes / 16); e += 128) {
    const int blk = 2 * (e / (kWBlockBytes / 16)) + wg, off = (e % (kWBlockBytes / 16)) * 16;
    __stcg(reinterpret_cast<int4*>(dst + static_cast<size_t>(blk) * kBlockBytes + off),
           *reinterpret_cast<const int4*>(src + blk * kWBlockBytes + off));
  }
}

// mlp_tile_x_masks' and dx_chain_x's hook in K6 full at 640 to 1024, and with
// RENDER in K1 and K4 full there (segments from dW[12], as OperandSaveW<D,
// true>'s): OperandSaveW's, but each warpgroup saves the blocks it wrote (2p +
// g in pass p); pe and de (one block each) and g_h (D/128 blocks) go by
// warpgroup 0, x7 (X operand 8), which density_head_dw_w reads back for
// dW[9], by the warpgroup's own stores (the kernel fences them before its
// barrier), every other operand by bulk copies. The column sums:
// store_dx_w<64, ..., SUM> writes pass p's four warp sums at red_pass(i, wg,
// p) + w 64 + c, so a layer's D/128 passes keep theirs apart in red_at(i,
// wg)'s 2 D floats (4 warps x 64 columns x D/128 passes: OperandSaveW's
// two-buffer layout of red_bytes_w's first 8 D floats, the other warpgroup's
// region untouched); grad(i) adds each column's four sums in warp order to
// the warpgroup's segment at the column's place, 128p + 64g + c of the
// layer's dB block.
template <int D, bool RENDER = false>
struct OperandSaveX : OperandSaveW<D, RENDER> {
  static constexpr int kPasses = D / kXCols;
  __device__ __forceinline__ void operator()(int i, int wg, const unsigned char* src) const {
    if (i == 0 || i == 10) {
      if (wg == 0) copy_blocks_w_async(src, this->tiles.x(i), 1);
      return;
    }
    if (i == 8)
      copy_own_blocks_x(src, this->tiles.x(i), wg, kPasses);
    else
      copy_own_blocks_x_async(src, this->tiles.x(i), wg, kPasses);
  }
  __device__ __forceinline__ void grad(int i, int wg, const unsigned char* src) const {
    if (i == 0) {
      if (wg == 0) copy_blocks_w_async(src, this->tiles.g(0), D / 128);
      return;
    }
    copy_own_blocks_x_async(src, this->tiles.g(i), wg, kPasses);
    const GradLayout lay = grad_layout(D);
    const int k = i == 1 ? 9 : 9 - i;   // the layer's dB block: g_feat's 9, g_l's l
    float* b = this->part + wg * this->seg + D + (lay.b[0] - (RENDER ? lay.w[12] : lay.w[13])) +
               (k == 9 ? lay.b[9] - lay.b[0] : k * D) + 64 * wg;
    for (int e = threadIdx.x & 127; e < 64 * kPasses; e += 128) {
      const int p = e >> 6, c = e & 63;
      const float* r = red_pass(i, wg, p) + c;
      b[kXCols * p + c] +=
          ((__ldcg(r) + __ldcg(r + 64)) + __ldcg(r + 128)) + __ldcg(r + 192);
    }
  }
  __device__ __forceinline__ float* red_pass(int i, int wg, int p) const {
    return this->red_at(i, wg) + 4 * 64 * p;
  }
};

// rgb_head_bwd_x's g_h bits (the rgb-hidden layer's passes of 64 columns,
// this warpgroup's 32 of each, its mask words) with the gradients that stay
// in the chain, as rgb_head_bwd_w_full forms them at 384 and 512: each thread
// reads h under its cells (the buffer's first D/2 columns) before it writes
// g_h over them, and sums over its two rows the masked f32 g_h (dB[10]) and h
// bf16(g_rgb[k]) (dW[13]); then the warp's eight row groups by shfl_xor over
// 4, 8, 16, and the warpgroup's four warps in order through red (4 sums x 4
// warps x the warpgroup's D/4 columns), added to the warpgroup's segment
// seg_wg at each column's place. dB[11] and dB[8], the tile's f32 sums of the
// raw-rgb and raw-density cotangents in row order, by four threads into seg0
// (the CTA's first segment). With RENDER (K1 and K4 full: segments from
// dW[12]) h comes from `hsrc`, the tile's h parked in device memory in the
// buffer's layout (the composite has had the buffer since the tile's
// forward), and each thread also sums its two rows' bf16 g_h, which go
// through rgb_head_bwd_x's warp and warpgroup order into ghsum: the same bits;
// red then holds five sums a column (red_bytes_w<D, true>), not four. Starts
// and ends synchronised (both warpgroups), the buffer fenced for wgmma.
template <int D, bool RENDER = false>
__device__ __forceinline__ void rgb_head_bwd_x_full(unsigned char* act, const float* grgb,
                                                    const float* graw, const uint32_t* mask_h,
                                                    const unsigned char* rgb_head, float* red,
                                                    float* seg0, float* seg_wg,
                                                    const unsigned char* hsrc = nullptr,
                                                    float* ghsum = nullptr) {
  constexpr int P = D / kXCols;     // the rgb-hidden layer's passes
  constexpr int N = kXHCols / 2;    // a warpgroup's columns of a pass
  constexpr int NW = P * N;         // ... of h
  constexpr int R = RENDER ? 5 : 4;   // sums a column
  const GradLayout lay = grad_layout(D);
  const int from = RENDER ? lay.w[12] : lay.w[13];   // the segments' first float
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, w = (tid >> 5) & 3;
  const int row = 16 * w + (lane >> 2), t = lane & 3;
  float* red_wg = red + wg * 4 * R * NW;   // [sum][warp][column]
  consumer_sync();   // the forward is done with the buffer, the cotangents are in
  float g[2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g[r][c] = bf16_round(grgb[4 * (row + 8 * r) + c]);
  }
#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    const uint32_t bits = __ldcg(mask_h + p * kConsumers + tid);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = kXHCols * p + N * wg + 8 * j + 2 * t;
      const uint32_t m = bits >> (4 * j);
      const __nv_bfloat162 h0 =
          RENDER ? ldcg_bf162(hsrc + swz(row, col, kWBlockBytes))
                 : *reinterpret_cast<const __nv_bfloat162*>(act + swz(row, col, kWBlockBytes));
      const __nv_bfloat162 h1 =
          RENDER ? ldcg_bf162(hsrc + swz(row + 8, col, kWBlockBytes))
                 : *reinterpret_cast<const __nv_bfloat162*>(act + swz(row + 8, col, kWBlockBytes));
      const float hv[2][2] = {{__low2float(h0), __high2float(h0)},
                              {__low2float(h1), __high2float(h1)}};
      float v[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float wo0 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(0, col + h, 1024)));
        const float wo1 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(1, col + h, 1024)));
        const float wo2 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(2, col + h, 1024)));
        v[h] = (m >> h) & 1u ? g[0][0] * wo0 + g[0][1] * wo1 + g[0][2] * wo2 : 0.f;
        v[2 + h] = (m >> (2 + h)) & 1u ? g[1][0] * wo0 + g[1][1] * wo1 + g[1][2] * wo2 : 0.f;
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<__nv_bfloat162*>(act + swz(row, col, kWBlockBytes)) = lo;
      *reinterpret_cast<__nv_bfloat162*>(act + swz(row + 8, col, kWBlockBytes)) = hi;
      float s[2][R];   // per column h: the masked g_h, then h bf16(g_rgb[k]), then bf16 g_h
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][0] = v[h] + v[2 + h];
#pragma unroll
        for (int k = 0; k < 3; ++k) s[h][1 + k] = hv[0][h] * g[0][k] + hv[1][h] * g[1][k];
      }
      if (RENDER) {
        s[0][R - 1] = __low2float(lo) + __low2float(hi);
        s[1][R - 1] = __high2float(lo) + __high2float(hi);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int q = 0; q < R; ++q) s[h][q] += __shfl_xor_sync(0xffffffffu, s[h][q], off);
        }
      }
      if ((lane >> 2) == 0) {
        const int lc = N * p + 8 * j + 2 * t;   // the warpgroup's column of h
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int q = 0; q < R; ++q) __stcg(red_wg + (4 * q + w) * NW + lc + h, s[h][q]);
        }
      }
    }
  }
  fence_proxy_async();
  consumer_sync();
  for (int lc = tid & 127; lc < NW; lc += 128) {
    float v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float* r = red_wg + 4 * q * NW + lc;
      v[q] = ((__ldcg(r) + __ldcg(r + NW)) + __ldcg(r + 2 * NW)) + __ldcg(r + 3 * NW);
    }
    const int c = kXHCols * (lc / N) + N * wg + lc % N;   // the column of h
    seg_wg[D + (lay.b[10] - from) + c] += v[0];
#pragma unroll
    for (int k = 0; k < 3; ++k) seg_wg[D + (lay.w[13] - from) + 3 * c + k] += v[1 + k];
    if (RENDER) ghsum[c] += v[R - 1];
  }
  if (tid < 4) {   // dB[11] (3) and dB[8]
    float acc = 0.f;
    if (tid < 3) {
      for (int m = 0; m < kWRows; ++m) acc += grgb[4 * m + tid];
      seg0[D + (lay.b[11] - from) + tid] += acc;
    } else {
      for (int m = 0; m < kWRows; ++m) acc += graw[m];
      seg0[D + (lay.b[8] - from)] += acc;
    }
  }
  consumer_sync();   // red is free again
}

// ---- the forward kernels' check builds -----------------------------------------
//
// render_fwd.cu (K3) and point_mlp_fwd.cu (K5) are also built with the X
// operands' part of the hook K1, K4 full and K6 full pass their forward
// (OperandSave at 128 and 256, OperandSaveW at 384 and 512): pe, x0..x7,
// feat and K5's de, in the dW kernel's tiled layout over `tile_bytes` per
// 64-column block, so a check holds them against the backward kernels' own,
// operand for operand. No main path runs those builds.
template <int D>
struct FwdOperandSave {
  using Save = std::conditional_t<(D > 256), OperandSaveW<D>, OperandSave<D>>;
  // The hook at pass 0: the activation buffer `act` and the encoding blocks
  // `pe` and `de` (null in K3, whose direction product is per ray).
  __device__ static Save make(const unsigned char* act, const unsigned char* pe,
                              const unsigned char* de, unsigned char* xops, size_t tile_bytes) {
    Save s{};
    if constexpr (D > 256) {
      s.tiles = PassTilesW<D>{xops, nullptr, tile_bytes, 0};
    } else {
      s.act = act;
      s.pe = pe;
      s.de = de;
      s.tiles = PassTiles<D>{xops, nullptr, tile_bytes, 0};
    }
    return s;
  }
};

// mlp_dx_wide_sm90.cuh's rgb_head_bwd_w (the same g_h bits) with the
// gradients that stay in the chain (rgb_head_bwd_full's at these widths):
// each thread also reads h under its cells before it writes g_h over them,
// and sums over its two rows the masked f32 g_h (dB[10]) and h bf16(g_rgb[k])
// (dW[13]); then the warp's eight row groups by shfl_xor over 4, 8, 16, and
// the warpgroup's four warps in order through red, added to the warpgroup's
// segment seg_wg. dB[11] and dB[8], the tile's f32 sums of the raw-rgb and
// raw-density cotangents in row order, by four threads into seg0 (the CTA's
// first segment). With RENDER (K1 and K4 full: segments from dW[12]) h comes
// from `hsrc`, the tile's h parked in device memory in the buffer's layout
// (the composite has had the buffers since the tile's forward), and each
// thread also sums its two rows' bf16 g_h, which go through the same warp
// and warpgroup order as rgb_head_bwd_w's into ghsum: the same bits; red then
// holds five sums a column, not four. Starts and ends synchronised (both
// warpgroups), the buffer fenced for wgmma.
template <int D, bool RENDER = false>
__device__ __forceinline__ void rgb_head_bwd_w_full(unsigned char* act, const float* grgb,
                                                    const float* graw, const uint32_t* mask_h,
                                                    const unsigned char* rgb_head, float* red,
                                                    float* seg0, float* seg_wg,
                                                    const unsigned char* hsrc = nullptr,
                                                    float* ghsum = nullptr) {
  constexpr int N = D / 4;   // a warpgroup's columns of h
  constexpr int W = mask_words_w<N>();
  constexpr int R = RENDER ? 5 : 4;   // sums a column
  const GradLayout lay = grad_layout(D);
  const int from = RENDER ? lay.w[12] : lay.w[13];   // the segments' first float
  unsigned char* buf = act + kWRows * D * 2;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, w = (tid >> 5) & 3;
  const int row = 16 * w + (lane >> 2), t = lane & 3;
  float* red_wg = red + wg * 4 * R * N;   // [sum][warp][column]
  consumer_sync();   // the forward is done with the buffers, the cotangents are in
  uint32_t bits[W];
#pragma unroll
  for (int k = 0; k < W; ++k) bits[k] = __ldcg(mask_h + k * kConsumers + tid);
  float g[2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g[r][c] = bf16_round(grgb[4 * (row + 8 * r) + c]);
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = wg * N + 8 * j + 2 * t;
    const uint32_t m = bits[(4 * j) >> 5] >> ((4 * j) & 31);
    const __nv_bfloat162 h0 =
        RENDER ? ldcg_bf162(hsrc + swz(row, col, kWBlockBytes))
               : *reinterpret_cast<const __nv_bfloat162*>(buf + swz(row, col, kWBlockBytes));
    const __nv_bfloat162 h1 =
        RENDER ? ldcg_bf162(hsrc + swz(row + 8, col, kWBlockBytes))
               : *reinterpret_cast<const __nv_bfloat162*>(buf + swz(row + 8, col, kWBlockBytes));
    const float hv[2][2] = {{__low2float(h0), __high2float(h0)}, {__low2float(h1), __high2float(h1)}};
    float v[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float wo0 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(0, col + h, 1024)));
      const float wo1 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(1, col + h, 1024)));
      const float wo2 = __bfloat162float(*reinterpret_cast<const bf16*>(rgb_head + swz(2, col + h, 1024)));
      v[h] = (m >> h) & 1u ? g[0][0] * wo0 + g[0][1] * wo1 + g[0][2] * wo2 : 0.f;
      v[2 + h] = (m >> (2 + h)) & 1u ? g[1][0] * wo0 + g[1][1] * wo1 + g[1][2] * wo2 : 0.f;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<__nv_bfloat162*>(buf + swz(row, col, kWBlockBytes)) = lo;
    *reinterpret_cast<__nv_bfloat162*>(buf + swz(row + 8, col, kWBlockBytes)) = hi;
    float s[2][R];   // per column h: the masked g_h, then h bf16(g_rgb[k]), then bf16 g_h
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h][0] = v[h] + v[2 + h];
#pragma unroll
      for (int k = 0; k < 3; ++k) s[h][1 + k] = hv[0][h] * g[0][k] + hv[1][h] * g[1][k];
    }
    if (RENDER) {
      s[0][R - 1] = __low2float(lo) + __low2float(hi);
      s[1][R - 1] = __high2float(lo) + __high2float(hi);
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < R; ++q) s[h][q] += __shfl_xor_sync(0xffffffffu, s[h][q], off);
      }
    }
    if ((lane >> 2) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < R; ++q) __stcg(red_wg + (4 * q + w) * N + 8 * j + 2 * t + h, s[h][q]);
      }
    }
  }
  fence_proxy_async();
  consumer_sync();
  const int lt = tid & 127;
  if (lt < N) {
    float v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float* r = red_wg + 4 * q * N + lt;
      v[q] = ((__ldcg(r) + __ldcg(r + N)) + __ldcg(r + 2 * N)) + __ldcg(r + 3 * N);
    }
    const int c = wg * N + lt;   // the column of h
    seg_wg[D + (lay.b[10] - from) + c] += v[0];
#pragma unroll
    for (int k = 0; k < 3; ++k) seg_wg[D + (lay.w[13] - from) + 3 * c + k] += v[1 + k];
    if (RENDER) ghsum[c] += v[R - 1];
  }
  if (tid < 4) {   // dB[11] (3) and dB[8]
    float acc = 0.f;
    if (tid < 3) {
      for (int m = 0; m < kWRows; ++m) acc += grgb[4 * m + tid];
      seg0[D + (lay.b[11] - from) + tid] += acc;
    } else {
      for (int m = 0; m < kWRows; ++m) acc += graw[m];
      seg0[D + (lay.b[8] - from)] += acc;
    }
  }
  consumer_sync();   // red is free again
}

// dW[9] += x7^T bf16(g_sigma) over the 64-point pass (columns tid and tid +
// 256): x7 read back from its operand tile (the warpgroups' own stores,
// fenced before the caller's barrier), gsbf the pass's 64 bf16-valued
// raw-density cotangents, w9 the CTA's first segment.
template <int D>
__device__ __forceinline__ void density_head_dw_w(const PassTilesW<D>& tiles, const float* gsbf,
                                                  float* w9) {
  const unsigned char* x7 = tiles.x(8);
  for (int c = threadIdx.x; c < D; c += kConsumers) {
    float acc = 0.f;
#pragma unroll 16
    for (int m = 0; m < kWRows; ++m)
      acc += __bfloat162float(__ushort_as_bfloat16(__ldcg(
                 reinterpret_cast<const unsigned short*>(x7 + swz(m, c, kBlockBytes))))) *
             gsbf[m];
    w9[c] += acc;
  }
}

}  // namespace
