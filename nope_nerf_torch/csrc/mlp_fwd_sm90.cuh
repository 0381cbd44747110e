// The forward NeRF MLP trunk on Hopper (sm_90a), shared by render_fwd.cu (K3)
// and point_mlp_fwd.cu (K5): one 128-point tile through the 9-layer MLP with
// its layer-4 skip, the feature and rgb-hidden layers and the f32 heads.
//
// Numerics are those of the TPU kernels: bf16 operands, f32 accumulators
// that start at the bias, activations rounded to bf16 after each ReLU,
// `feat` rounded without one, the skip as a second product into the same
// accumulators, heads f32. Only the order in which the tensor cores sum a
// product's terms differs.
//
// Design:
// - A CTA is two consumer warpgroups and one producer warpgroup (384
//   threads). It is persistent: the kernel launches at most one CTA per SM,
//   and each walks over its share of the tiles. `setmaxnreg` moves registers
//   from the producer (56 a thread) to the consumers (224), whose layer
//   accumulators take 128 at D=256.
// - The producer's first warp feeds the weight ring (below); its other three
//   warps encode the next tile's inputs (positions, and in K5 directions)
//   into shared memory while the consumers run the current tile, handing
//   each buffer over by a pair of mbarriers (full: the encoding is written;
//   free: the consumers' last product on it is done).
// - Warpgroup g owns rows 64g..64g+63 of the tile. Every layer is one
//   `wgmma.mma_async` m64nNk16 (N = the layer's full width) per 16 columns of
//   K, with A, the activations, and B, the weights, both read from shared
//   memory in the canonical K-major layout with the 128-byte swizzle: a
//   64-column block of R rows is R rows of 128 bytes, whose 16-byte chunk c
//   of row r sits at chunk c ^ (r % 8). A warpgroup reads only its own rows,
//   so once its products are done it writes the layer's output over its
//   input: one activation buffer (128 x D bf16) serves every layer.
// - The weights stream through a ring of slices in shared memory. A slice is
//   one 64-column block of one layer's (out, in) weight, (N x 64) bf16,
//   32 KB at D=256. The wrapper (ops/fused_render.py::pack_tiles) lays every
//   slice out in device memory once per call, pre-swizzled and in the order
//   the layers consume them, so the producer fetches slice i with one
//   `cp.async.bulk` of contiguous bytes, completing on the stage's `full`
//   mbarrier. Each consumer warp arrives on the stage's `empty` mbarrier when
//   its products on the slice have finished. The ring runs on across layers,
//   passes and tiles, so the next layer's first slices load while the current
//   one computes and while the tile's encoding and epilogues run.
// - Each slice is read from L2 once per 128-point tile.
// - The heads (N = 8) are `wgmma` m64n8k16 on head weights that stay in
//   shared memory for the whole kernel.
// - Epilogue stores are generic-proxy writes that the next `wgmma` reads
//   through the async proxy: every one is followed by `fence.proxy.async`
//   and a warpgroup barrier before the next product.

#pragma once

#include "nerf_mlp.cuh"   // bf16, kPts, kPe, kDe, kEps, dense_lane, density_act

namespace {

constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kThreads90 = kConsumers + 128;     // + the producer warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kEncoders = 96;                    // the producer warpgroup's warps 1..3
constexpr int kConsumerRegs = 224;               // setmaxnreg: 256 x 224 + 128 x 56
constexpr int kProducerRegs = 56;                //   <= the SM's 65,536 registers
static_assert(kConsumers * kConsumerRegs + (kThreads90 - kConsumers) * kProducerRegs <= 65536,
              "the register split must fit the SM's register file");
constexpr int kBlockBytes = kPts * 128;          // one swizzled 64-column block of a tile
constexpr int kWgRowBytes = 64 * 128;            // a warpgroup's 64 rows of such a block
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;               // a block's shared memory on sm_90

// The tiled weight buffer of ops/fused_render.py::pack_tiles, in bytes. Slices
// in the order one pass consumes them:
//   w0 (1), w1..w3 (D/64 each), w4 (D/64), w5 (1), w6..w8 (D/64 each),
//   w10 (D/64)                                   -- "full" slices, D x 64
//   w11 (D/64), w12 (1, its 32 columns padded to 64)  -- "half" slices, D/2 x 64
// then the density head w9 (8 x D) and the rgb head w13 (8 x D/2), each as
// 64-column blocks of 8 rows (1 KB), loaded once per CTA.
template <int D>
struct Tiles {
  static constexpr int kFull = D * 128;
  static constexpr int kHalf = D * 64;
  static constexpr int kTrunk = 1 + 3 * (D / 64) + (D / 64 + 1) + 3 * (D / 64) + D / 64;
  static constexpr int kRender = kTrunk + D / 64;      // K3 folds w12 into a per-ray bias
  static constexpr int kPoint = kTrunk + D / 64 + 1;   // K5 takes w12 as a product
  static constexpr size_t kW12 = static_cast<size_t>(kTrunk) * kFull + (D / 64) * kHalf;
  static constexpr size_t kHeads = kW12 + kHalf;
  static constexpr int kDensHead = 8 * D * 2;
  static constexpr int kRgbHead = 8 * (D / 2) * 2;
  __device__ static size_t offset(int i) {
    return i < kTrunk ? static_cast<size_t>(i) * kFull
                      : static_cast<size_t>(kTrunk) * kFull + static_cast<size_t>(i - kTrunk) * kHalf;
  }
  __device__ static uint32_t bytes(int i) { return i < kTrunk ? kFull : kHalf; }
};

// The 12 f32 biases in pack_weights' order, a kernel argument.
struct Biases {
  const float* b[12];
};

// Byte offset of element (r, c) in a tile of 64-column swizzled blocks whose
// blocks are `block_bytes` apart.
__host__ __device__ __forceinline__ uint32_t swz(int r, int c, uint32_t block_bytes) {
  return (c >> 6) * block_bytes + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that outlasts
// some 2^26 polls (tens of seconds) is a protocol fault: it traps, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls > (1u << 26)) __trap();
  }
}

// Contiguous bytes from device memory to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The two consumer warpgroups together (barrier 1), or one of them (2 + g).
__device__ __forceinline__ void consumer_sync() { named_sync(1, kConsumers); }
__device__ __forceinline__ void wg_sync(int wg) { named_sync(2 + wg, 128); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d[64 x N] += A[64 x 16] B[N x 16]^T, bf16 in, f32 accumulators (wgmma's
// fragment: d[4j + h] is row 16w + l/4 + 8(h/2), column 8j + 2(l%4) + h%2 for
// warp w of the warpgroup and lane l).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// ---- the trunk ----------------------------------------------------------------

// The consumer side of the weight ring: `it` counts the slices consumed so
// far (the same in every consumer thread), so slice `it` is in stage
// it % stages with phase (it / stages) & 1.
struct Ring {
  uint32_t base;     // shared address of stage 0
  uint32_t full;     // shared address of the stages' full barriers (8 bytes each)
  uint32_t empty;    // ... and of their empty barriers
  uint32_t stride;   // bytes per stage
  int stages;
  uint32_t it;
};

// acc += A[rows of this warpgroup, 64 kblocks] B^T over the next `kblocks`
// slices of the ring (`ksteps` products of 16 columns each). A starts at the
// shared address `a` (its blocks kBlockBytes apart). Waits for every product
// and releases every slice before it returns.
template <int N>
__device__ __forceinline__ void ring_products(float (&acc)[N / 2], uint32_t a, int kblocks,
                                              int ksteps, Ring& ring) {
  const bool leader = (threadIdx.x & 31) == 0;
  uint32_t prev = 0;
  for (int kb = 0; kb < kblocks; ++kb) {
    const uint32_t stage = ring.it % ring.stages;
    mbar_wait(ring.full + 8 * stage, (ring.it / ring.stages) & 1);
    const uint32_t b = ring.base + stage * ring.stride;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < ksteps)
        wgmma_bf16<N>(acc, sw128_desc(a + kb * kBlockBytes + 32 * k), sw128_desc(b + 32 * k));
    }
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();
      if (leader) mbar_arrive(ring.empty + 8 * prev);
    }
    prev = stage;
    ++ring.it;
  }
  wgmma_wait<0>();
  if (leader) mbar_arrive(ring.empty + 8 * prev);
}

// acc = bias per column (the fragment of wgmma_bf16).
template <int N>
__device__ __forceinline__ void acc_bias(float (&acc)[N / 2], const float* bias) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float b0 = bias[8 * j + 2 * t], b1 = bias[8 * j + 2 * t + 1];
    acc[4 * j] = b0;
    acc[4 * j + 1] = b1;
    acc[4 * j + 2] = b0;
    acc[4 * j + 3] = b1;
  }
}

// The warpgroup's 64 rows of act (generic pointer to its first row in block 0)
// = bf16(act(acc)), swizzled; then fenced for the async proxy.
template <int N, bool RELU>
__device__ __forceinline__ void store_act(const float (&acc)[N / 2], unsigned char* act_wg) {
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
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(act_wg + swz(row, col, kBlockBytes)) =
        __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(act_wg + swz(row + 8, col, kBlockBytes)) =
        __floats2bfloat162_rn(v2, v3);
  }
  fence_proxy_async();
}

// f32 head on the warpgroup's rows: hout[4p + col_off + c] = (x @ w^T + bias)[p, c]
// for c < ncols, x the first K columns of act, w the resident (8 x K) head.
template <int K>
__device__ __forceinline__ void head90(uint32_t act_wg, uint32_t w, const float* __restrict__ bias,
                                       float* hout_wg, int col_off, int ncols) {
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
    wgmma_bf16<8>(acc, sw128_desc(act_wg + (k >> 2) * kBlockBytes + 32 * (k & 3)),
                  sw128_desc(w + (k >> 2) * 1024 + 32 * (k & 3)));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 2 * t + h;
    if (c < ncols) {
      hout_wg[row * 4 + col_off + c] = acc[h];
      hout_wg[(row + 8) * 4 + col_off + c] = acc[2 + h];
    }
  }
}

// Shared addresses of the encoders' handshakes: the position and direction
// encoding buffers, each with a full (kEncoders arrivals) and a free
// (kConsumerWarps arrivals) barrier. Tile t of a CTA waits on phase t & 1.
struct Handoff {
  uint32_t pe_full, pe_free, de_full, de_free;
};

// The MLP over one 128-point tile (the CTA's tile number `tile`), run by each
// consumer warpgroup on its 64 rows: position encodings in `pe` (one block),
// the activation buffer `act` (D/64 blocks), the heads resident at dens_w /
// rgb_w (shared addresses). The rgb-hidden layer starts from `hbias` and, when
// de != 0, adds the product of the direction encodings (one block at shared
// address de, 32 live columns) with w12. Raw rgb and density go to
// hout[4p + 0..3]; ends with the warpgroup's products done and its hout rows
// written. Waits for the encodings and frees them after their last product.
template <int D>
__device__ __forceinline__ void mlp_tile90(const float* const* b, uint32_t pe, uint32_t de,
                                           unsigned char* act, uint32_t dens_w, uint32_t rgb_w,
                                           const float* hbias, float* hout, const Handoff& hand,
                                           long long tile, Ring& ring) {
  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 31) == 0;
  const uint32_t parity = static_cast<uint32_t>(tile & 1);
  unsigned char* act_g = act + wg * kWgRowBytes;
  const uint32_t act_s = smem_addr(act) + wg * kWgRowBytes;
  const uint32_t pe_s = pe + wg * kWgRowBytes;
  float* hout_wg = hout + 4 * 64 * wg;
  mbar_wait(hand.pe_full, parity);
  {
    float acc[D / 2];
    acc_bias<D>(acc, b[0]);
    ring_products<D>(acc, pe_s, 1, 4, ring);
    wg_sync(wg);
    store_act<D, true>(acc, act_g);
    wg_sync(wg);
#pragma unroll 1
    for (int l = 1; l < 8; ++l) {
      acc_bias<D>(acc, b[l]);
      ring_products<D>(acc, act_s, D / 64, 4, ring);
      if (l == 4) {
        ring_products<D>(acc, pe_s, 1, 4, ring);   // the skip: pe @ w5, pe's last use
        if (leader) mbar_arrive(hand.pe_free);
      }
      wg_sync(wg);
      store_act<D, true>(acc, act_g);
      wg_sync(wg);
    }
    // x7: density head (raw, f32) and feat (bf16, no ReLU)
    head90<D>(act_s, dens_w, b[8], hout_wg, 3, 1);
    acc_bias<D>(acc, b[9]);
    ring_products<D>(acc, act_s, D / 64, 4, ring);
    wg_sync(wg);
    store_act<D, false>(acc, act_g);
    wg_sync(wg);
  }
  float acc[D / 4];
  acc_bias<D / 2>(acc, hbias);
  ring_products<D / 2>(acc, act_s, D / 64, 4, ring);
  if (de != 0) {
    mbar_wait(hand.de_full, parity);
    ring_products<D / 2>(acc, de + wg * kWgRowBytes, 1, kDe / 16, ring);
    if (leader) mbar_arrive(hand.de_free);
  }
  wg_sync(wg);
  store_act<D / 2, true>(acc, act_g);
  wg_sync(wg);
  head90<D / 2>(act_s, rgb_w, b[11], hout_wg, 0, 3);
}

// The producer warpgroup's thread 0: the heads once, then `slices` slices per tile
// for `tiles` tiles, each into the next free stage of the ring.
template <int D>
__device__ __forceinline__ void produce(const unsigned char* __restrict__ w, uint32_t heads,
                                        uint32_t head_bar, Ring ring, long long tiles,
                                        int slices) {
  using T = Tiles<D>;
  mbar_expect_tx(head_bar, T::kDensHead + T::kRgbHead);
  bulk_load(heads, w + T::kHeads, T::kDensHead + T::kRgbHead, head_bar);
  for (long long tile = 0; tile < tiles; ++tile) {
    for (int i = 0; i < slices; ++i) {
      const uint32_t stage = ring.it % ring.stages;
      mbar_wait(ring.empty + 8 * stage, ((ring.it / ring.stages) & 1) ^ 1);
      mbar_expect_tx(ring.full + 8 * stage, T::bytes(i));
      bulk_load(ring.base + stage * ring.stride, w + T::offset(i), T::bytes(i),
                ring.full + 8 * stage);
      ++ring.it;
    }
  }
}

// Shared memory common to both kernels, from a 1024-aligned base: the
// activation buffer (128 x D bf16), the position-encoding block (16 KB), an
// optional direction-encoding block, the heads (8 x D and 8 x D/2 bf16), the
// ring, then 8-byte barriers (kBars) and the kernel's own f32 arrays.
constexpr int kBars = 2 * kMaxStages + 5;   // full, empty, heads, Handoff

template <int D>
struct Layout90 {
  uint32_t act, pe, de, heads, ring, bars, f32;
  int stages;
  __host__ __device__ Layout90(bool with_de, size_t f32_bytes) {
    act = 0;
    pe = act + kPts * D * 2;
    de = pe + kBlockBytes;
    heads = de + (with_de ? kBlockBytes : 0);
    ring = heads + Tiles<D>::kDensHead + Tiles<D>::kRgbHead;
    const size_t rest = 8 * kBars + f32_bytes + 1024;   // + the alignment slack
    const long long room = static_cast<long long>(kSmemLimit) - ring - static_cast<long long>(rest);
    const long long fit = room / Tiles<D>::kFull;
    stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
    bars = ring + stages * Tiles<D>::kFull;
    f32 = bars + 8 * kBars;
  }
  __host__ __device__ size_t bytes(size_t f32_bytes) const { return f32 + f32_bytes + 1024; }
};

// Where a render kernel (render_fwd.cu, render_bwd_frozen.cu,
// render_full_sm90.cuh) keeps a ray's per-sample f32 arrays. Its own arrays
// (z, the raw heads, ...: `sample_floats` a sample) stay in the kernel's
// shared f32 area, before its fixed arrays, while they fit there beside two
// ring stages; the composite's (alpha, the scan buffers, ...:
// `composite_floats` a sample) borrow `room` bytes of the activation buffer
// while they fit. Past that, each set goes to the CTA's share of a scratch in
// device memory, which L1 and the 50 MB L2 keep close: at S = 2048 and 64 B a
// sample, 17 MB over 132 CTAs. The same threads read and write every array
// in the same order wherever it lives, so a ray's results do not depend on
// the place. The kernels find the arrays through ray_arrays at run time;
// render_bwd_frozen.cu alone is built twice (SPILL), with plain shared-memory
// addresses for the sizes where both sets fit, which keeps its register
// allocation, and so its time, at those sizes.
struct RayPlace {
  int samples_smem, composite_smem, sample_floats, composite_floats;
  __host__ __device__ long long spill_floats(int S) const {
    return static_cast<long long>(S) *
           ((samples_smem ? 0 : sample_floats) + (composite_smem ? 0 : composite_floats));
  }
  __host__ __device__ bool spills(int S) const { return spill_floats(S) > 0; }
  // The kernel's shared f32 area: `fixed` bytes, and the sample arrays where they fit.
  __host__ __device__ size_t area(size_t fixed, int S) const {
    return fixed + (samples_smem ? sizeof(float) * sample_floats * static_cast<size_t>(S) : 0);
  }
};

template <int D>
RayPlace ray_place(int S, int sample_floats, int composite_floats, size_t fixed, size_t room) {
  RayPlace p{1, 1, sample_floats, composite_floats};
  p.samples_smem = Layout90<D>(false, p.area(fixed, S)).stages >= 2;
  p.composite_smem = sizeof(float) * composite_floats * static_cast<size_t>(S) <= room;
  return p;
}

// The ray's arrays: `samples` (sample_floats S floats, then the fixed arrays
// at `fixed`) and `composite` (composite_floats S), from the kernel's shared
// f32 area `f32`, the activation buffer's free room and its CTA's share of
// `spill`.
struct RayArrays {
  float* samples;
  float* fixed;
  float* composite;
};

__device__ __forceinline__ RayArrays ray_arrays(const RayPlace& p, int S, float* f32, float* room,
                                                float* spill) {
  float* own = spill + static_cast<long long>(blockIdx.x) * p.spill_floats(S);
  RayArrays a;
  a.samples = p.samples_smem ? f32 : own;
  a.fixed = p.samples_smem ? f32 + static_cast<size_t>(p.sample_floats) * S : f32;
  a.composite = p.composite_smem ? room
                                 : own + (p.samples_smem ? 0 : static_cast<size_t>(p.sample_floats) * S);
  return a;
}

// Set up the CTA: align the dynamic shared memory, initialise the barriers
// (full: one arrival plus the bytes; empty: one arrival per consumer warp;
// the heads'; the Handoff's). Returns the aligned base. Ends synchronised.
__device__ __forceinline__ unsigned char* setup90(unsigned char* raw, uint32_t bars, int stages) {
  const uint32_t raw_s = smem_addr(raw);
  unsigned char* base = raw + (((raw_s + 1023) & ~1023u) - raw_s);
  if (threadIdx.x == 0) {
    const uint32_t b = smem_addr(base + bars);
    for (int s = 0; s < stages; ++s) {
      mbar_init(b + 8 * s, 1);
      mbar_init(b + 8 * (kMaxStages + s), kConsumerWarps);
    }
    mbar_init(b + 16 * kMaxStages, 1);
    mbar_init(b + 16 * kMaxStages + 8, kEncoders);        // pe full
    mbar_init(b + 16 * kMaxStages + 16, kConsumerWarps);  // pe free
    mbar_init(b + 16 * kMaxStages + 24, kEncoders);       // de full
    mbar_init(b + 16 * kMaxStages + 32, kConsumerWarps);  // de free
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return base;
}

__device__ __forceinline__ Ring make_ring(unsigned char* base, uint32_t ring, uint32_t bars,
                                          uint32_t stride, int stages) {
  Ring r;
  r.base = smem_addr(base + ring);
  r.full = smem_addr(base + bars);
  r.empty = r.full + 8 * kMaxStages;
  r.stride = stride;
  r.stages = stages;
  r.it = 0;
  return r;
}

__device__ __forceinline__ Handoff make_handoff(const Ring& ring) {
  const uint32_t h = ring.full + 16 * kMaxStages;
  return Handoff{h + 8, h + 16, h + 24, h + 32};
}

// Waits until the consumers are done with the buffer that tile `tile` of the
// CTA is about to be encoded into (its previous tile's free phase).
__device__ __forceinline__ void wait_free(uint32_t free_bar, long long tile) {
  if (tile > 0) mbar_wait(free_bar, static_cast<uint32_t>((tile - 1) & 1));
}

// The encoders' share of one tile's dense-lane frequency encoding
// [x | sin(2^i x_c) at 3+3i+c | cos(2^i x_c) at 3+3L+3i+c | 0] (nerf_mlp.cuh's
// dense_lane), bf16, written swizzled into the block `enc`. coord(p, c) is
// coordinate c of point p. An item is one (level, coordinate) pair of a point,
// whose sine and cosine come from one sincosf, or the point's identity and
// zero lanes.
template <int LEVELS, int LANES, typename Coord>
__device__ __forceinline__ void encode_tile(unsigned char* enc, int etid, Coord coord) {
  constexpr int kItems = 3 * LEVELS + 1;
  auto put = [enc](int p, int k, float v) {
    *reinterpret_cast<bf16*>(enc + swz(p, k, 0)) = __float2bfloat16_rn(v);
  };
  for (int e = etid; e < kPts * kItems; e += kEncoders) {
    const int p = e / kItems, j = e % kItems;
    if (j < 3 * LEVELS) {
      float sn, cs;
      sincosf(coord(p, j % 3) * static_cast<float>(1 << (j / 3)), &sn, &cs);  // exact scaling
      put(p, 3 + j, sn);
      put(p, 3 + 3 * LEVELS + j, cs);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) put(p, c, coord(p, c));
#pragma unroll
      for (int k = 3 + 6 * LEVELS; k < LANES; ++k) put(p, k, 0.f);
    }
  }
}

// An encoder's part of a tile is written: fence it for wgmma, then arrive.
__device__ __forceinline__ void hand_over(uint32_t full_bar) {
  fence_proxy_async();
  mbar_arrive(full_bar);
}

__device__ __forceinline__ void set_consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}
__device__ __forceinline__ void set_producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}

// The number of SMs of the current device (one persistent CTA each).
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace
