// The forward NeRF MLP trunk at hidden_dim 384 and 512 on Hopper (sm_90a):
// one 64-point tile through the 9-layer MLP with its layer-4 skip, the
// feature and rgb-hidden layers and the f32 heads (mlp_tile_w_masks), the one
// forward of every kernel at these widths: render_fwd.cu (K3) and
// point_mlp_fwd.cu (K5) run it, and so does every backward kernel before its
// dX chain (mlp_dx_wide_sm90.cuh), which keeps its ReLU masks. At 128 and 256
// every kernel runs mlp_fwd_sm90.cuh's 128-point trunk; FwdTrunk<D> (below)
// picks one or the other for K3 and K5.
//
// Numerics are those of mlp_fwd_sm90.cuh and the TPU kernels: bf16 operands,
// f32 accumulators that start at the bias, each 32-column weight slice's
// product summed from zero and added in slice order (ring_products_wp),
// activations rounded to bf16 after each ReLU, `feat` rounded without one,
// heads f32.
//
// Why a tile shape of its own. In the 128-point trunk each consumer
// warpgroup owns 64 rows and computes every column of a layer as one wgmma of
// N = D: D/2 f32 accumulators a thread, 192 at D = 384 and 256 at 512, past
// what a thread can hold beside its addresses (and wgmma stops at N = 256).
// Splitting N in two inside a warpgroup would need the first half's output
// staged, since each warpgroup writes a layer's output over its input, and
// neither a stage nor a second 128-row buffer fits in shared memory at 512.
//
// Design:
// - A tile is 64 points. Its two consumer warpgroups split each layer's
//   output columns: warpgroup g computes columns [gD/2, (g+1)D/2) of all 64
//   rows, N = D/2: 96 and 128 accumulators a thread, as D = 256 takes in the
//   128-point trunk, each 32-column slice of K summed in pieces of 64 of
//   those columns (32 where N = 96), one `wgmma.mma_async` m64nPk16 per 16
//   columns of the slice. The rgb-hidden layer (D/2 wide) splits the same
//   way, N = D/4.
// - Both warpgroups read every column of a layer's input, so neither may
//   write over it: two activation buffers of 64 x D bf16 take turns (ten
//   stores a tile, so a tile starts in buffer 0), and one 256-thread barrier
//   a layer hands the output over. The barrier after a layer also ends every
//   read of the buffer the next layer writes.
// - The weights stream through the ring of mlp_fwd_sm90.cuh in slices of 32
//   columns, (D x 32) bf16, 32 KB at D = 512 (half the rows for the
//   rgb-hidden layer): at 64 columns two stages would not fit beside the
//   activations. A slice's rows are 64 bytes, stored in the 64-byte swizzle
//   (16-byte chunk c of row r at chunk c ^ ((r / 2) % 4)) that the B
//   descriptor names; warpgroup g reads its D/2 rows of each slice. The
//   activations and encodings keep the 128-byte swizzle of 64-column blocks
//   (64 rows, 8 KB). ops/fused_render.py::pack_tiles lays the slices out.
// - Warpgroup 1 computes the density head while both run the feature layer;
//   warpgroup 0 the rgb head at the end of the tile. Both heads stay resident
//   in shared memory, as in the 128-point trunk.
// - Shared memory at D = 512: activations 2 x 64 KB, position encodings 8 KB
//   (and K5's direction encodings 8 KB), heads 12 KB, two ring stages of 32 KB:
//   212 KB (220 KB in K5) before the barriers and the kernels' f32 arrays. At
//   D = 384: 96 + 8 (+ 8) + 9 KB and four stages of 24 KB.
// - The cost: a slice is read from L2 once per 64 points, not 128, so the
//   products meet half as many points per byte of weights. Multicasting the
//   slices to a 2-CTA cluster that shares a 128-point tile is the later fix.

#pragma once

#include <type_traits>

#include "mlp_fwd_sm90.cuh"

namespace {

constexpr int kWRows = 64;                       // points of a wide tile
constexpr int kWBlockBytes = kWRows * 128;       // one 64-column block of a wide tile
constexpr int kWSliceCols = 32;                  // weight columns of one ring slice

// d[64 x N] += A[64 x 16] B[N x 16]^T at the wide trunk's warpgroup widths:
// N = D/2 = 192 and the rgb-hidden layer's N = D/4 = 96 at D = 384 (128 and
// 256 at D = 512 are mlp_fwd_sm90.cuh's).
template <>
__device__ __forceinline__ void wgmma_bf16<192>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

// The tiled weight buffer of ops/fused_render.py::pack_tiles at 384 and 512,
// in bytes. Slices of 32 columns in the order one tile consumes them:
//   w0 (2), w1..w3 (D/32 each), w4 (D/32), w5 (2), w6..w8 (D/32 each),
//   w10 (D/32)                                  -- "full" slices, D x 32
//   w11 (D/32), w12 (1)                         -- "half" slices, D/2 x 32
// then the density head w9 (8 x D) and the rgb head w13 (8 x D/2), each as
// 64-column blocks of 8 rows (1 KB) in the 128-byte swizzle, loaded once per CTA.
template <int D>
struct TilesW {
  static_assert(D == 384 || D == 512, "the wide trunk takes hidden_dim 384 and 512");
  static constexpr int kFull = D * kWSliceCols * 2;
  static constexpr int kHalf = D / 2 * kWSliceCols * 2;
  static constexpr int kPeSlices = kPe / kWSliceCols;
  static constexpr int kK = D / kWSliceCols;            // slices of a D-column weight
  static constexpr int kTrunk = 2 * kPeSlices + 8 * kK;
  static constexpr int kRender = kTrunk + kK;           // K3 folds w12 into a per-ray bias
  static constexpr int kPoint = kTrunk + kK + 1;        // K5 takes w12 as a product
  static constexpr size_t kW12 = static_cast<size_t>(kTrunk) * kFull + kK * kHalf;
  static constexpr size_t kHeads = kW12 + kHalf;
  static constexpr int kDensHead = 8 * D * 2;
  static constexpr int kRgbHead = 8 * (D / 2) * 2;
  __device__ static size_t offset(int i) {
    return i < kTrunk ? static_cast<size_t>(i) * kFull
                      : static_cast<size_t>(kTrunk) * kFull + static_cast<size_t>(i - kTrunk) * kHalf;
  }
  __device__ static uint32_t bytes(int i) { return i < kTrunk ? kFull : kHalf; }
};

// Byte offset of element (r, c) of one 32-column slice (64-byte rows, the
// 64-byte swizzle).
__host__ __device__ __forceinline__ uint32_t swz64(int r, int c) {
  return r * 64 + ((((c & 31) >> 3) ^ ((r >> 1) & 3)) << 4) + (c & 7) * 2;
}

// Shared-memory matrix descriptor: K-major, 64-byte swizzle, 8-row groups
// 512 bytes apart.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// acc += A[the tile's 64 rows] B^T over the next `slices` slices of the
// ring, B = this warpgroup's rows of each slice (`b_off` bytes into the
// stage). A starts at the shared address `a` (64-column blocks kWBlockBytes
// apart); slice s meets its columns 32s..32s+31. Waits for every product and
// releases every slice before it returns.
template <int N>
__device__ __forceinline__ void ring_products_w(float (&acc)[N / 2], uint32_t a, int slices,
                                                uint32_t b_off, Ring& ring) {
  const bool leader = (threadIdx.x & 31) == 0;
  uint32_t prev = 0;
  for (int s = 0; s < slices; ++s) {
    const uint32_t stage = ring.it % ring.stages;
    mbar_wait(ring.full + 8 * stage, (ring.it / ring.stages) & 1);
    const uint32_t b = ring.base + stage * ring.stride + b_off;
    const uint32_t as = a + (s >> 1) * kWBlockBytes + (s & 1) * 64;
    wgmma_fence();
    wgmma_bf16<N>(acc, sw128_desc(as), sw64_desc(b));
    wgmma_bf16<N>(acc, sw128_desc(as + 32), sw64_desc(b + 32));
    wgmma_commit();
    if (s > 0) {
      wgmma_wait<1>();
      if (leader) mbar_arrive(ring.empty + 8 * prev);
    }
    prev = stage;
    ++ring.it;
  }
  wgmma_wait<0>();
  if (leader) mbar_arrive(ring.empty + 8 * prev);
}

// Columns col0..col0+N-1 of a wide activation buffer (generic pointer to its
// row 0) = bf16(act(acc)), swizzled; then fenced for the async proxy.
template <int N, bool RELU>
__device__ __forceinline__ void store_w(const float (&acc)[N / 2], unsigned char* buf, int col0) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int row = 16 * w + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
    if (RELU) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
      v2 = fmaxf(v2, 0.f);
      v3 = fmaxf(v3, 0.f);
    }
    const int col = col0 + 8 * j + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(buf + swz(row, col, kWBlockBytes)) =
        __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(buf + swz(row + 8, col, kWBlockBytes)) =
        __floats2bfloat162_rn(v2, v3);
  }
  fence_proxy_async();
}

// f32 head on the tile's 64 rows, by one warpgroup: hout[4p + col_off + c] =
// (x @ w^T + bias)[p, c] for c < ncols, x the first K columns of the wide
// activation buffer at `act`, w the resident (8 x K) head.
template <int K>
__device__ __forceinline__ void head_w(uint32_t act, uint32_t w, const float* __restrict__ bias,
                                       float* hout, int col_off, int ncols) {
  const int lane = threadIdx.x & 31, wp = (threadIdx.x >> 5) & 3;
  const int t = lane & 3, row = 16 * wp + (lane >> 2);
  float acc[4];
  acc[0] = bias[2 * t];
  acc[1] = bias[2 * t + 1];
  acc[2] = acc[0];
  acc[3] = acc[1];
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < K / 16; ++k)
    wgmma_bf16<8>(acc, sw128_desc(act + (k >> 2) * kWBlockBytes + 32 * (k & 3)),
                  sw128_desc(w + (k >> 2) * 1024 + 32 * (k & 3)));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 2 * t + h;
    if (c < ncols) {
      hout[row * 4 + col_off + c] = acc[h];
      hout[(row + 8) * 4 + col_off + c] = acc[2 + h];
    }
  }
}

// ---- ReLU masks in device memory ------------------------------------------------

// 32-bit words a consumer thread keeps for an N-column share of a layer
// (N / 2 accumulators, one bit each).
template <int N>
__host__ __device__ constexpr int mask_words_w() { return (N / 2 + 31) / 32; }

// Words of one tile's masks: x0..x7 (N = D/2 a warpgroup) then h (D/4), each
// as [word][consumer thread].
template <int D>
__host__ __device__ constexpr int mask_layer_words_w() { return mask_words_w<D / 2>() * kConsumers; }
template <int D>
__host__ __device__ constexpr size_t mask_tile_bytes_w() {
  return sizeof(uint32_t) *
         (8 * static_cast<size_t>(mask_layer_words_w<D>()) + mask_words_w<D / 4>() * kConsumers);
}

// store_w's output and, for a ReLU layer, the mask of the stored bf16 values
// to `mask` (this layer's words, device memory: past L1), then fenced for the
// async proxy.
template <int N, bool RELU>
__device__ __forceinline__ void store_w_mask(const float (&acc)[N / 2], unsigned char* buf,
                                             int col0, uint32_t* mask) {
  constexpr int W = mask_words_w<N>();
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int row = 16 * w + (lane >> 2), t = lane & 3;
  uint32_t bits[W];
#pragma unroll
  for (int k = 0; k < W; ++k) bits[k] = 0u;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
    if (RELU) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
      v2 = fmaxf(v2, 0.f);
      v3 = fmaxf(v3, 0.f);
    }
    const int col = col0 + 8 * j + 2 * t;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1), hi = __floats2bfloat162_rn(v2, v3);
    *reinterpret_cast<__nv_bfloat162*>(buf + swz(row, col, kWBlockBytes)) = lo;
    *reinterpret_cast<__nv_bfloat162*>(buf + swz(row + 8, col, kWBlockBytes)) = hi;
    if (RELU) {
      const int b = (4 * j) & 31, k = (4 * j) >> 5;
      bits[k] |= ((__low2float(lo) > 0.f ? 1u : 0u) << b) |
                 ((__high2float(lo) > 0.f ? 1u : 0u) << (b + 1)) |
                 ((__low2float(hi) > 0.f ? 1u : 0u) << (b + 2)) |
                 ((__high2float(hi) > 0.f ? 1u : 0u) << (b + 3));
    }
  }
  if (RELU) {
#pragma unroll
    for (int k = 0; k < W; ++k) __stcg(mask + k * kConsumers + threadIdx.x, bits[k]);
  }
  fence_proxy_async();
}

// A ReLU layer's epilogue: store_w's output, with MASKS also its mask
// (store_w_mask).
template <int N, bool MASKS>
__device__ __forceinline__ void store_w_relu(const float (&acc)[N / 2], unsigned char* buf,
                                             int col0, uint32_t* mask) {
  if constexpr (MASKS)
    store_w_mask<N, true>(acc, buf, col0, mask);
  else
    store_w<N, true>(acc, buf, col0);
}

// ---- the forward ----------------------------------------------------------------

// ring_products_w with each slice's product summed from zero, P columns at a
// time, and added to acc by the CUDA cores (round to nearest). The tensor
// cores truncate as they accumulate, so a sum carried across all of K drifts
// towards zero, one step of 16 columns at a time: at K = 512 that flipped 2 to
// 3 x as many bf16 roundings and ReLU masks as an f32 evaluation. A slice's
// sum starts from zero, so its truncation is on the scale of 32 products and
// of either sign, and the running sum is rounded to nearest. Each piece waits
// for its own products before it is added (mlp_fwd_sm90.cuh's
// ring_products_p: the schedule measured faster, PERF.md section 6).
template <int N>
__device__ __forceinline__ void ring_products_wp(float (&acc)[N / 2], uint32_t a, int slices,
                                                 uint32_t b_off, Ring& ring) {
  constexpr int P = N % 64 == 0 ? 64 : 32;   // N = 96: three pieces of 32
  const bool leader = (threadIdx.x & 31) == 0;
  for (int s = 0; s < slices; ++s) {
    const uint32_t stage = ring.it % ring.stages;
    mbar_wait(ring.full + 8 * stage, (ring.it / ring.stages) & 1);
    const uint32_t b = ring.base + stage * ring.stride + b_off;
    const uint32_t as = a + (s >> 1) * kWBlockBytes + (s & 1) * 64;
#pragma unroll
    for (int c = 0; c < N / P; ++c) {
      float t[P / 2];
#pragma unroll
      for (int i = 0; i < P / 2; ++i) t[i] = 0.f;
      const uint32_t bc = b + c * P * 64;   // the piece's rows of the slice (64 bytes each)
      wgmma_fence();
      wgmma_bf16<P>(t, sw128_desc(as), sw64_desc(bc));
      wgmma_bf16<P>(t, sw128_desc(as + 32), sw64_desc(bc + 32));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < P / 2; ++i) acc[c * (P / 2) + i] += t[i];
    }
    if (leader) mbar_arrive(ring.empty + 8 * stage);
    ++ring.it;
  }
}

// No operand leaves the tile. A hook of the kernels with weight gradients
// saves X operand i (0 pe, 1..8 x0..x7, 9 feat, 10 de) from the shared
// buffer `src` once it is written (operator()), G operand i (0 g_h, 1
// g_feat, 2..9 g7..g0) from `src` after its epilogue (grad), and finishes
// reading shared memory before the next write over a saved buffer (drain).
// With kSum each dX epilogue also writes its warps' column sums to
// red_at(i, wg), which grad(i) reads.
struct NoSaveW {
  static constexpr bool kSum = false;
  __device__ __forceinline__ void operator()(int, int, const unsigned char*) const {}
  __device__ __forceinline__ void grad(int, int, const unsigned char*) const {}
  __device__ __forceinline__ void drain(int) const {}
  __device__ __forceinline__ float* red_at(int, int) const { return nullptr; }
};

// The forward of every kernel at D = 384 and 512 (K3, K5, and inside K1, K4
// and K6, full and frozen; mlp_fwd_sm90.cuh's mlp_tile_masks at 128 and
// 256): the MLP over one 64-point tile (the CTA's tile number `tile`), run
// by both consumer warpgroups. Position encodings in `pe` (one block of 64
// rows), the two activation buffers at `act` (64 x D bf16 each), the heads
// resident at dens_w / rgb_w (shared addresses). Each layer starts from its
// bias; each 32-column slice's product is summed from zero and added in slice
// order (ring_products_wp); the same roundings as at 128 and 256. The
// rgb-hidden layer starts from `hbias` and, when de != 0, adds the product of
// the direction encodings (one block at shared address de, 32 live columns)
// with w12. x_l lands in buffer l % 2, feat in buffer 0 and h in buffer 1.
// Raw rgb and density go to hout[4p + 0..3]; ends with every product done
// and hout's rows written, by warpgroup 0 (rgb) and 1 (density): the caller
// synchronises the consumers before it reads them. Waits for the encodings
// and frees them after their last product. With MASKS (the backward kernels)
// the ReLU layers' masks go to `masks` (one tile's words, device memory);
// `save` is NoSaveW's kind of hook (the X operands' part of it).
template <int D, bool MASKS = true, typename Save = NoSaveW>
__device__ __forceinline__ void mlp_tile_w_masks(const float* const* b, uint32_t pe, uint32_t de,
                                                 unsigned char* act, uint32_t dens_w,
                                                 uint32_t rgb_w, const float* hbias, float* hout,
                                                 const Handoff& hand, long long tile, Ring& ring,
                                                 uint32_t* masks, const Save& save = Save()) {
  using T = TilesW<D>;
  constexpr int N = D / 2;
  constexpr int H = D / 4;
  constexpr uint32_t kBuf = kWRows * D * 2;
  constexpr int LW = mask_layer_words_w<D>();
  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 31) == 0;
  const uint32_t parity = static_cast<uint32_t>(tile & 1);
  const uint32_t act_s = smem_addr(act);
  const uint32_t b_full = wg * N * kWSliceCols * 2;
  const uint32_t b_half = wg * H * kWSliceCols * 2;
  const unsigned char* pe_g = act + (pe - act_s);
  mbar_wait(hand.pe_full, parity);
  save(0, wg, pe_g);
  {
    float acc[N / 2];
    acc_bias<N>(acc, b[0] + wg * N);
    ring_products_wp<N>(acc, pe, T::kPeSlices, b_full, ring);
    store_w_relu<N, MASKS>(acc, act, wg * N, masks);
    consumer_sync();
    save(1, wg, act);
#pragma unroll 1
    for (int l = 1; l < 8; ++l) {
      const uint32_t in = (l & 1) ? 0u : kBuf;
      acc_bias<N>(acc, b[l] + wg * N);
      ring_products_wp<N>(acc, act_s + in, T::kK, b_full, ring);
      if (l == 4) {
        ring_products_wp<N>(acc, pe, T::kPeSlices, b_full, ring);
        if (leader) mbar_arrive(hand.pe_free);
      }
      save.drain(wg);
      store_w_relu<N, MASKS>(acc, act + (kBuf - in), wg * N, masks + l * LW);
      consumer_sync();
      save(1 + l, wg, act + (kBuf - in));
    }
    if (wg == 1) head_w<D>(act_s + kBuf, dens_w, b[8], hout, 3, 1);
    acc_bias<N>(acc, b[9] + wg * N);
    ring_products_wp<N>(acc, act_s + kBuf, T::kK, b_full, ring);
    save.drain(wg);
    store_w<N, false>(acc, act, wg * N);
    consumer_sync();
    save(9, wg, act);
  }
  float acc[H / 2];
  acc_bias<H>(acc, hbias + wg * H);
  ring_products_wp<H>(acc, act_s, T::kK, b_half, ring);
  if (de != 0) {
    mbar_wait(hand.de_full, parity);
    save(10, wg, act + (de - act_s));
    ring_products_wp<H>(acc, de, 1, b_half, ring);
    save.drain(wg);
    if (leader) mbar_arrive(hand.de_free);
  }
  save.drain(wg);
  store_w_relu<H, MASKS>(acc, act + kBuf, wg * H, masks + 8 * LW);
  consumer_sync();
  if (wg == 0) head_w<D / 2>(act_s + kBuf, rgb_w, b[11], hout, 0, 3);
}

// Shared memory of a wide kernel, from a 1024-aligned base: the two
// activation buffers (64 x D bf16 each), the position-encoding block (8 KB),
// an optional direction-encoding block, the heads, the ring, then 8-byte
// barriers (kBars) and the kernel's own f32 arrays. Layout90's members.
template <int D>
struct LayoutW {
  uint32_t act, pe, de, heads, ring, bars, f32;
  int stages;
  __host__ __device__ LayoutW(bool with_de, size_t f32_bytes) {
    act = 0;
    pe = act + 2 * kWRows * D * 2;
    de = pe + kWBlockBytes;
    heads = de + (with_de ? kWBlockBytes : 0);
    ring = heads + TilesW<D>::kDensHead + TilesW<D>::kRgbHead;
    const size_t rest = 8 * kBars + f32_bytes + 1024;   // + the alignment slack
    const long long room = static_cast<long long>(kSmemLimit) - ring - static_cast<long long>(rest);
    const long long fit = room / TilesW<D>::kFull;
    stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
    bars = ring + stages * TilesW<D>::kFull;
    f32 = bars + 8 * kBars;
  }
  __host__ __device__ size_t bytes(size_t f32_bytes) const { return f32 + f32_bytes + 1024; }
};

// What K3 and K5 take from their trunk at width D: the 128-point trunk of
// mlp_fwd_sm90.cuh at 128 and 256, the 64-point one above at 384 and 512.
// kRows: points of a tile; kActBytes: the activation buffers' bytes (which
// K3's composite borrows once a ray's tiles are done); w12(j, k): element
// (j, k) of the direction part of the rgb-hidden weight in the buffer;
// tile(..., save): the backward kernels' forward without its masks, with
// the trunk's kind of save hook (NoHook on the main paths).
template <int D, bool WIDE = (D > 256)>
struct FwdTrunk;
template <int D>
struct FwdTrunk<D, false> {
  using T = Tiles<D>;
  using NoHook = NoSave;
  using Layout = Layout90<D>;
  static constexpr int kRows = kPts;
  static constexpr size_t kActBytes = static_cast<size_t>(kPts) * D * 2;
  __device__ static void feed(const unsigned char* w, uint32_t heads, uint32_t head_bar, Ring ring,
                              long long tiles, int slices) {
    produce<D>(w, heads, head_bar, ring, tiles, slices);
  }
  template <typename Save>
  __device__ static void tile(const float* const* b, uint32_t pe, uint32_t de, unsigned char* act,
                              uint32_t dens_w, uint32_t rgb_w, const float* hbias, float* hout,
                              const Handoff& hand, long long t, Ring& ring, const Save& save) {
    mlp_tile_masks<D, false>(b, pe, de, act, dens_w, rgb_w, hbias, hout, hand, t, ring, nullptr,
                             save);
  }
  __device__ static float w12(const unsigned char* w, int j, int k) {
    return __bfloat162float(*reinterpret_cast<const bf16*>(w + T::kW12 + swz(j, k, 0)));
  }
};

template <int D>
struct FwdTrunk<D, true> {
  using T = TilesW<D>;
  using NoHook = NoSaveW;
  using Layout = LayoutW<D>;
  static constexpr int kRows = kWRows;
  static constexpr size_t kActBytes = static_cast<size_t>(2 * kWRows) * D * 2;
  __device__ static void feed(const unsigned char* w, uint32_t heads, uint32_t head_bar, Ring ring,
                              long long tiles, int slices) {
    produce<D, TilesW<D>>(w, heads, head_bar, ring, tiles, slices);
  }
  template <typename Save>
  __device__ static void tile(const float* const* b, uint32_t pe, uint32_t de, unsigned char* act,
                              uint32_t dens_w, uint32_t rgb_w, const float* hbias, float* hout,
                              const Handoff& hand, long long t, Ring& ring, const Save& save) {
    mlp_tile_w_masks<D, false>(b, pe, de, act, dens_w, rgb_w, hbias, hout, hand, t, ring, nullptr,
                               save);
  }
  __device__ static float w12(const unsigned char* w, int j, int k) {
    return __bfloat162float(*reinterpret_cast<const bf16*>(w + T::kW12 + swz64(j, k)));
  }
};

}  // namespace
