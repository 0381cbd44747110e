// Weight gradients dW = X^T G over a set of points on Hopper (sm_90a): the
// dW half of K6 (nope_nerf_tpu/ops/pallas_mlp.py::_bwd_kernel's `_dmat`
// products, pallas_mlp.py:197-199), standalone and generic, so that every
// backward kernel of the port can form its dW products here from operands
// its dX chain has written.
//
// What it computes: for each block of a small work table, dW (K, N) f32 =
// X^T G, with X (M, K) and G (M, N) bf16 in device memory, each product term
// exact in f32 and summed in f32, as `_dmat` does (bf16 operands, f32
// accumulation). Rows past M read as zero in both operands.
//
// Operand layout ("tiled", ops/fused_mlp.py::tile_operand): an (M, C) bf16
// operand is ceil(M/128) row tiles, each ceil(C/64) blocks of 128 rows x 128
// bytes, the 16-byte chunk c of row r stored at chunk c ^ (r % 8): the
// 128-byte swizzle of the activation buffer of mlp_fwd_sm90.cuh. The chains
// write their operands in it straight from that buffer, and each 64-column
// block of a row tile is one contiguous 16 KB bulk copy.
//
// Bound: at the fine pass's 196,608 points and D = 256, 0.233 TFLOP (0.24 ms
// at the bf16 peak) against 1.9 GB of operands read once (0.57 ms at 3.35
// TB/s): bytes.
//
// Design:
// - A CTA tile is (block, 128 rows of dW): two consumer warpgroups, each
//   owning 64 rows (64 columns of X), sharing the block's whole G (N <= 256
//   columns), and a producer warpgroup whose first thread streams, per row
//   tile of points, the CTA's X blocks and all of G's through a ring of two
//   96 KB stages by cp.async.bulk, completing on mbarriers.
// - The product is one wgmma m64nNk16 per 16 points, A = X^T and B = G both
//   read from shared memory as they arrived: the points are the reduction
//   (K) dimension and both tiles keep the feature (M or N) dimension
//   contiguous, so both descriptors are MN-major (the transpose bits of the
//   16-bit types), with the 128-byte swizzle, 8-point groups 1024 bytes apart
//   and 64-column blocks 16 KB apart.
// - The points are split into `chunks` contiguous runs of row tiles (from M
//   and the SM count, ops/fused_mlp.py::dw_chunks); the grid is (CTA tiles,
//   chunks), each writes an f32 partial dW, and a second launch sums the
//   partials in chunk order. No float atomics: two launches give the same bits.

#pragma once

#include "mlp_fwd_sm90.cuh"   // PTX wrappers, swz, kBlockBytes, the CTA's thread split

namespace {

constexpr int kDwMaxBlocks = 16;
constexpr int kDwStageX = 2 * kBlockBytes;          // the CTA's two 64-column blocks of X
constexpr int kDwStageG = 4 * kBlockBytes;          // G's blocks: N <= 256
constexpr int kDwStage = kDwStageX + kDwStageG;     // 96 KB
constexpr int kDwStages = 2;
constexpr size_t kDwSmem = static_cast<size_t>(kDwStages) * kDwStage + 8 * 2 * kDwStages + 1024;

// One dW block: X and G (tiled, xblocks and gblocks 64-column blocks per row
// tile), dW (K, N) f32 row-major at dst, and its place in a chunk's partial
// buffer. K <= 64 xblocks, N = 64 gblocks in {64, 128, 256}.
struct DwBlock {
  const unsigned char* x;
  const unsigned char* g;
  float* dst;
  long long part;
  int xblocks, gblocks, K, N;
};

struct DwTable {
  DwBlock b[kDwMaxBlocks];
  int first[kDwMaxBlocks + 1];   // each block's first CTA tile; first[n]: the CTA tiles
  int n;
  long long part_total;          // floats of one chunk's partial buffer
};

// d[64 x N] += A[64 x 16] B[16 x N], both operands MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_tt(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tt<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_tt<256>(float (&d)[128], uint64_t da, uint64_t db) {
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
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
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

// Shared-memory matrix descriptor of an MN-major operand: 128-byte swizzle,
// 64-column (MN) blocks kBlockBytes apart (the leading byte offset), 8-row
// (K) groups 1024 bytes apart (the stride byte offset).
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kBlockBytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// Rows n..127 of `blocks` swizzled blocks at `p` (generic), zeroed by the
// consumer threads.
__device__ __forceinline__ void dw_zero_rows(unsigned char* p, int blocks, int n) {
  const int per = (kPts - n) * 8;   // 16-byte chunks past row n in a block
  for (int e = threadIdx.x; e < blocks * per; e += kConsumers) {
    const int blk = e / per, c = e % per;
    *reinterpret_cast<int4*>(p + blk * kBlockBytes + n * 128 + 16 * c) = make_int4(0, 0, 0, 0);
  }
}

// The consumers' side of one CTA tile: rows k0 + 64 wg.. of the block's dW
// over row tiles [t0, t1), into the chunk's partial `part` (K, N).
template <int N>
__device__ __forceinline__ void dw_consume(const DwBlock& bk, int k0, long long t0, long long t1,
                                           long long M, unsigned char* stages, uint32_t full,
                                           uint32_t empty, float* __restrict__ part) {
  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 31) == 0;
  const bool active = k0 + 64 * wg < bk.K;
  const long long last = (M + kPts - 1) / kPts - 1;
  const int ragged = static_cast<int>(M - last * kPts);   // rows of the last row tile
  const int xb = min(2, bk.xblocks - k0 / 64);
  const uint32_t stages_s = smem_addr(stages);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t it = 0, prev = 0;
  for (long long t = t0; t < t1; ++t, ++it) {
    const uint32_t stage = it % kDwStages;
    mbar_wait(full + 8 * stage, (it / kDwStages) & 1);
    if (t == last && ragged < kPts) {   // rows past M read as zero
      unsigned char* s = stages + stage * kDwStage;
      dw_zero_rows(s, xb, ragged);
      dw_zero_rows(s + kDwStageX, N / 64, ragged);
      fence_proxy_async();
      consumer_sync();
    }
    if (active) {
      const uint32_t sx = stages_s + stage * kDwStage;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kPts / 16; ++k)
        wgmma_tt<N>(acc, sw128_desc_mn(sx + wg * kBlockBytes + 2048 * k),
                    sw128_desc_mn(sx + kDwStageX + 2048 * k));
      wgmma_commit();
      if (it > 0) wgmma_wait<1>();
    }
    if (it > 0 && leader) mbar_arrive(empty + 8 * prev);
    prev = stage;
  }
  if (active) wgmma_wait<0>();
  if (it > 0 && leader) mbar_arrive(empty + 8 * prev);
  if (!active) return;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int row = k0 + 64 * wg + 16 * w + (lane >> 2), t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (row < bk.K)
      *reinterpret_cast<float2*>(part + static_cast<size_t>(row) * N + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < bk.K)
      *reinterpret_cast<float2*>(part + static_cast<size_t>(row + 8) * N + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kThreads90, 1)
dw_sm90_kernel(const __grid_constant__ DwTable tab, long long M, float* __restrict__ partials) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = smem_addr(smem_raw);
  unsigned char* stages = smem_raw + (((raw_s + 1023) & ~1023u) - raw_s);
  const uint32_t full = smem_addr(stages + kDwStages * kDwStage);
  const uint32_t empty = full + 8 * kDwStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int bi = 0;
  while (bi + 1 < tab.n && static_cast<int>(blockIdx.x) >= tab.first[bi + 1]) ++bi;
  const DwBlock& bk = tab.b[bi];
  const int k0 = 128 * (static_cast<int>(blockIdx.x) - tab.first[bi]);
  const long long nt = (M + kPts - 1) / kPts;
  const long long chunks = gridDim.y, c = blockIdx.y;
  const long long t0 = c * nt / chunks, t1 = (c + 1) * nt / chunks;

  if (threadIdx.x >= kConsumers) {
    set_producer_regs();
    if (threadIdx.x != kConsumers) return;
    const int xb = min(2, bk.xblocks - k0 / 64);
    const uint32_t bytes = static_cast<uint32_t>(xb + bk.gblocks) * kBlockBytes;
    const uint32_t stages_s = smem_addr(stages);
    uint32_t it = 0;
    for (long long t = t0; t < t1; ++t, ++it) {
      const uint32_t stage = it % kDwStages;
      mbar_wait(empty + 8 * stage, ((it / kDwStages) & 1) ^ 1);
      mbar_expect_tx(full + 8 * stage, bytes);
      const uint32_t dst = stages_s + stage * kDwStage;
      for (int i = 0; i < xb; ++i)
        bulk_load(dst + i * kBlockBytes,
                  bk.x + (static_cast<size_t>(t) * bk.xblocks + k0 / 64 + i) * kBlockBytes,
                  kBlockBytes, full + 8 * stage);
      for (int j = 0; j < bk.gblocks; ++j)
        bulk_load(dst + kDwStageX + j * kBlockBytes,
                  bk.g + (static_cast<size_t>(t) * bk.gblocks + j) * kBlockBytes, kBlockBytes,
                  full + 8 * stage);
    }
    return;
  }
  set_consumer_regs();
  float* part = partials + c * tab.part_total + bk.part;
  switch (bk.N) {
    case 256:
      dw_consume<256>(bk, k0, t0, t1, M, stages, full, empty, part);
      break;
    case 128:
      dw_consume<128>(bk, k0, t0, t1, M, stages, full, empty, part);
      break;
    default:
      dw_consume<64>(bk, k0, t0, t1, M, stages, full, empty, part);
  }
}

// dst of each block = its chunks' partials summed in chunk order.
__global__ void dw_reduce_kernel(const __grid_constant__ DwTable tab, int chunks,
                                 const float* __restrict__ partials) {
  const DwBlock& bk = tab.b[blockIdx.y];
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(bk.K) * bk.N) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += partials[c * tab.part_total + bk.part + e];
  bk.dst[e] = acc;
}

// Checks the table, fills `first` and `part_total`, and launches both
// kernels on `stream`. partials: chunks x part_total f32 (scratch).
// 0 < chunks <= the row tiles of M.
inline cudaError_t dw_sm90_launch(DwTable& tab, long long M, int chunks, float* partials,
                                  cudaStream_t stream) {
  const long long nt = (M + kPts - 1) / kPts;
  if (M <= 0 || chunks <= 0 || chunks > nt || tab.n <= 0 || tab.n > kDwMaxBlocks)
    return cudaErrorInvalidValue;
  int tiles = 0, max_kn = 0;
  long long part = 0;
  for (int i = 0; i < tab.n; ++i) {
    DwBlock& b = tab.b[i];
    if ((b.N != 64 && b.N != 128 && b.N != 256) || b.gblocks * 64 != b.N || b.K <= 0 ||
        b.K > 64 * b.xblocks || b.x == nullptr || b.g == nullptr || b.dst == nullptr ||
        reinterpret_cast<uintptr_t>(b.x) % 16 != 0 || reinterpret_cast<uintptr_t>(b.g) % 16 != 0)
      return cudaErrorInvalidValue;
    tab.first[i] = tiles;
    tiles += (b.K + 127) / 128;
    b.part = part;
    part += static_cast<long long>(b.K) * b.N;
    max_kn = b.K * b.N > max_kn ? b.K * b.N : max_kn;
  }
  tab.first[tab.n] = tiles;
  tab.part_total = part;
  cudaError_t err = cudaFuncSetAttribute(dw_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kDwSmem));
  if (err != cudaSuccess) return err;
  dw_sm90_kernel<<<dim3(tiles, chunks), kThreads90, kDwSmem, stream>>>(tab, M, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_reduce_kernel<<<dim3((max_kn + 255) / 256, tab.n), 256, 0, stream>>>(tab, chunks, partials);
  return cudaGetLastError();
}

}  // namespace
