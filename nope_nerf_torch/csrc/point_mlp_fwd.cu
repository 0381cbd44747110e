// Point-query NeRF MLP forward on Hopper (sm_90a).
//
// Replaces the TPU kernel nope_nerf_tpu/ops/pallas_mlp.py::_fwd_kernel (reached
// through _raw_forward / nerf_apply_fused, the MLP query of the unfused render:
// the coarse and fine passes of hierarchical sampling, and any sample count the
// fused render does not take). For M points and M directions (f32, (M, 3) each)
// it computes, without writing any per-point intermediate to device memory:
//   dense-lane frequency encodings [xyz | 30 sin | 30 cos | 0] of the point and
//   [xyz | 12 sin | 12 cos | 0] of the direction, rounded to bf16
//   -> 9-layer MLP with the layer-4 skip -> density and rgb heads
//   -> softplus or relu density, 1 - exp(-sigma) unless the head's dist_alpha
//      is set, sigmoid rgb.
// Outputs: rgb (M, 3) and density (M, 1), f32.
//
// Numerics follow the TPU kernel: bf16 matmul operands with f32 accumulation,
// activations rounded to bf16 after each ReLU, `feat` rounded without one,
// heads f32. The MLP is the point-query backward kernels' own forward
// (mlp_tile_masks / mlp_tile_w_masks without the masks), so K6 recomputes
// this kernel's activations bit for bit, as the JAX kernels share _fwd_tail.
// Where the TPU kernel takes (M, 64) and (M, 32) padded encodings
// from device memory and writes (M, 128) padded head outputs, this kernel
// encodes each pass from the (M, 3) inputs in shared memory and writes only
// the 4 live outputs per point; it masks its own ragged last pass (rows
// n..127 are zero), so M needs no padding.
//
// Bound: compute. A point is 593,408 multiply-adds (the 63 and 27 live
// encoding lanes counted), 1.187 MFLOP, against 40 bytes of input and output
// and 1.2 MB of weights per launch: at the main path's 131,072 and 196,608
// points the least time is the FLOPs over the card's dense bf16 rate.
//
// Design: the wgmma trunk of mlp_fwd_sm90.cuh over 128 consecutive points at
// D = 128 and 256, that of mlp_fwd_wide_sm90.cuh over 64 at 384 and 512.
// Persistent CTAs, at most one per SM, walk over the passes blockIdx.x,
// blockIdx.x + gridDim.x, ...; the producer warpgroup streams the weight
// slices through the ring across passes and encodes the next pass's points
// and directions while the consumers run the current one. The direction
// encoding is per point here, so the rgb-hidden layer takes it as a second
// product (128 x 32) x (32 x D/2) into the same accumulators.
//
// Shared memory at D=256: activations 64 KB, position and direction
// encodings one 16 KB block each, resident heads 6 KB, raw heads 2 KB,
// barriers and slack ~1.2 KB, and a ring of 3 stages of 32 KB (201 KB of 227).
// At D=512: activations 2 x 64 KB, encodings 8 KB each, heads 12 KB, raw
// heads 1 KB and 2 stages of 32 KB (222 KB); at 384, 4 stages of 24 KB.
//
// Bound at the wide widths: 0.514 TFLOP at 196,608 points at D = 384 and
// 0.905 at D = 512, the FLOPs over the dense bf16 rate.
//
// At 640 to 1024 the passes run on mlp_fwd_xwide_sm90.cuh's trunk (64
// points, one activation buffer, each layer in passes of 128 columns), whose
// staging in device memory the wrapper allocates (nerf_point_mlp_fwd_stage).
// Shared memory at D = 1024: activations 128 KB, encodings 8 KB each, heads
// 24 KB, 3 ring stages of 16 KB. Bound: 1.405 TFLOP at 196,608 points at 640,
// 3.562 at 1024.

#include "mlp_dw_chain_sm90.cuh"   // FwdOperandSave (the check build)
#include "mlp_fwd_xwide_sm90.cuh"

namespace {

// f32 arrays: raw heads (points of a tile, 4).
template <int D>
constexpr size_t point_f32_bytes() {
  return sizeof(float) * FwdTrunk<D>::kRows * 4;
}

// SAVE: the check build, which also writes the X operands of every pass to
// `xops` (FwdOperandSave).
template <int D, bool SAVE>
__global__ void __launch_bounds__(kThreads90, 1)
point_mlp_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                     const unsigned char* __restrict__ tiles, Biases bias,
                     float* __restrict__ rgb, float* __restrict__ density, unsigned char* xops,
                     long long M, int occ_softplus, int head_dist_alpha,
                     typename FwdTrunk<D>::Layout L) {
  using F = FwdTrunk<D>;
  using T = typename F::T;
  using Save = std::conditional_t<SAVE, typename FwdOperandSave<D>::Save, typename F::NoHook>;
  constexpr int P = F::kRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = setup90(smem_raw, L.bars, L.stages);
  Ring ring = make_ring(base, L.ring, L.bars, T::kFull, L.stages);
  const uint32_t head_bar = ring.full + 16 * kMaxStages;
  const uint32_t heads = smem_addr(base + L.heads);
  const Handoff hand = make_handoff(ring);
  const long long n_pass = (M + P - 1) / P;

  if (threadIdx.x >= kConsumers) {
    set_producer_regs();
    const int etid = threadIdx.x - kConsumers - 32;
    if (threadIdx.x == kConsumers) {
      const long long mine = (n_pass - blockIdx.x + gridDim.x - 1) / gridDim.x;
      F::feed(tiles, heads, head_bar, ring, mine, T::kPoint);
    } else if (etid >= 0) {
      // encoders: the CTA's passes in order, rows n..P-1 of a ragged last
      // pass from zero points and directions
      unsigned char* pe = base + L.pe;
      unsigned char* de = base + L.de;
      long long tile = 0;
      for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x, ++tile) {
        const long long p0 = pass * P;
        const int n = static_cast<int>(M - p0 < P ? M - p0 : P);
        wait_free(hand.pe_free, tile);
        encode_tile<10, kPe, P>(pe, etid, [&](int p, int c) {
          return p < n ? pts[3 * (p0 + p) + c] : 0.f;
        });
        hand_over(hand.pe_full);
        wait_free(hand.de_free, tile);
        encode_tile<4, kDe, P>(de, etid, [&](int p, int c) {
          return p < n ? dirs[3 * (p0 + p) + c] : 0.f;
        });
        hand_over(hand.de_full);
      }
    }
    return;
  }
  set_consumer_regs();

  float* hout = reinterpret_cast<float*>(base + L.f32);   // rgb raw | sigma raw (P, 4)
  const uint32_t pe_s = smem_addr(base + L.pe), de_s = smem_addr(base + L.de);
  const int tid = threadIdx.x;
  Save save{};
  if constexpr (SAVE)
    save = FwdOperandSave<D>::make(base + L.act, base + L.pe, base + L.de, xops,
                                   static_cast<size_t>((M + kPts - 1) / kPts) * kBlockBytes);
  mbar_wait(head_bar, 0);

  long long tile = 0;
  for (long long pass = blockIdx.x; pass < n_pass; pass += gridDim.x, ++tile) {
    const long long p0 = pass * P;
    const int n = static_cast<int>(M - p0 < P ? M - p0 : P);
    if constexpr (SAVE) save.tiles.pass = pass;
    if constexpr (D > 512)   // the trunk past 512 also takes the CTA's staging
      F::tile(bias.b, pe_s, de_s, base + L.act, heads, heads + T::kDensHead, bias.b[10], hout,
              hand, tile, ring, save, L.cta_stage());
    else
      F::tile(bias.b, pe_s, de_s, base + L.act, heads, heads + T::kDensHead, bias.b[10], hout,
              hand, tile, ring, save);
    consumer_sync();   // both warpgroups' raw heads are in
    for (int p = tid; p < n; p += kConsumers) {
      const float sigma = density_act(hout[4 * p + 3], occ_softplus);
      density[p0 + p] = head_dist_alpha ? sigma : 1.f - expf(-sigma);
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[3 * (p0 + p) + c] = 1.f / (1.f + expf(-hout[4 * p + c]));
    }
    consumer_sync();   // hout is read before the next pass's heads overwrite it
  }
  if constexpr (SAVE) bulk_complete();   // every bulk copy of the CTA's operands, before it exits
}

// The grid: one persistent CTA per SM, at most one per pass of D's trunk.
template <int D>
int point_grid(long long M) {
  const int sms = sm_count();
  const long long n_pass = (M + FwdTrunk<D>::kRows - 1) / FwdTrunk<D>::kRows;
  return static_cast<int>(n_pass < sms ? n_pass : sms);
}

// Bytes of the staging of the trunk past 512 for M points (0 at 128 to 512).
template <int D>
long long point_stage_bytes(long long M) {
  if constexpr (D > 512)
    return static_cast<long long>(point_grid<D>(M)) *
           static_cast<long long>(TilesX<D>::kStageBytes);
  return 0;
}

template <int D, bool SAVE>
cudaError_t launch_fwd(const float* pts, const float* dirs, const unsigned char* tiles,
                       const Biases& bias, float* rgb, float* density, unsigned char* stage,
                       unsigned char* xops, long long M, int occ_softplus, int head_dist_alpha,
                       cudaStream_t stream) {
  typename FwdTrunk<D>::Layout L(true, point_f32_bytes<D>());
  if (L.stages < 2) return cudaErrorInvalidValue;
  if constexpr (D > 512) {
    if (stage == nullptr) return cudaErrorInvalidValue;
    L.stage = stage;
  }
  const size_t smem = L.bytes(point_f32_bytes<D>());
  cudaError_t err = cudaFuncSetAttribute(point_mlp_fwd_kernel<D, SAVE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = point_grid<D>(M);
  if (grid <= 0) return cudaErrorInvalidDevice;
  point_mlp_fwd_kernel<D, SAVE><<<grid, kThreads90, smem, stream>>>(
      pts, dirs, tiles, bias, rgb, density, xops, M, occ_softplus, head_dist_alpha, L);
  return cudaGetLastError();
}

// Both C entries: the main build (xops null) or the check build.
template <bool SAVE>
int point_fwd_entry(const float* pts, const float* dirs, const void* tiles,
                    const void* const* biases, float* rgb, float* density, void* stage_v,
                    unsigned char* xops, long long M, int D, int occ_softplus,
                    int head_dist_alpha, void* stream) {
  if (M <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Biases bias;
  for (int i = 0; i < 12; ++i) bias.b[i] = static_cast<const float*>(biases[i]);
  const auto* w = static_cast<const unsigned char*>(tiles);
  auto* stage = static_cast<unsigned char*>(stage_v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 1024:
      err = launch_fwd<1024, SAVE>(pts, dirs, w, bias, rgb, density, stage, xops, M,
                                   occ_softplus, head_dist_alpha, st);
      break;
    case 896:
      err = launch_fwd<896, SAVE>(pts, dirs, w, bias, rgb, density, stage, xops, M,
                                  occ_softplus, head_dist_alpha, st);
      break;
    case 768:
      err = launch_fwd<768, SAVE>(pts, dirs, w, bias, rgb, density, stage, xops, M,
                                  occ_softplus, head_dist_alpha, st);
      break;
    case 640:
      err = launch_fwd<640, SAVE>(pts, dirs, w, bias, rgb, density, stage, xops, M,
                                  occ_softplus, head_dist_alpha, st);
      break;
    case 512:
      err = launch_fwd<512, SAVE>(pts, dirs, w, bias, rgb, density, stage, xops, M,
                                  occ_softplus, head_dist_alpha, st);
      break;
    case 384:
      err = launch_fwd<384, SAVE>(pts, dirs, w, bias, rgb, density, stage, xops, M,
                                  occ_softplus, head_dist_alpha, st);
      break;
    case 256:
      err = launch_fwd<256, SAVE>(pts, dirs, w, bias, rgb, density, stage, xops, M,
                                  occ_softplus, head_dist_alpha, st);
      break;
    case 128:
      err = launch_fwd<128, SAVE>(pts, dirs, w, bias, rgb, density, stage, xops, M,
                                  occ_softplus, head_dist_alpha, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_mlp.py.
// pts, dirs (M, 3) f32 contiguous on the device; tiles: the weight buffer of
// fused_render.pack_tiles (16-byte aligned); biases: an array of 12 device
// pointers in pack_weights' order; rgb (M, 3) and density (M, 1) f32
// (out); stage: the bytes nerf_point_mlp_fwd_stage gives (null where it
// gives 0). Returns a cudaError_t (0 on success); the launch is asynchronous
// on `stream`.
extern "C" int nerf_point_mlp_fwd(const float* pts, const float* dirs, const void* tiles,
                                  const void* const* biases, float* rgb, float* density,
                                  void* stage, long long M, int D, int occ_softplus,
                                  int head_dist_alpha, void* stream) {
  return point_fwd_entry<false>(pts, dirs, tiles, biases, rgb, density, stage, nullptr, M, D,
                                occ_softplus, head_dist_alpha, stream);
}

// Bytes of nerf_point_mlp_fwd's staging for M points at width D: 64 x (D -
// 128) bf16 for each CTA of the grid at 640 to 1024, 0 at 128 to 512; -1 for
// a width the kernel does not take.
extern "C" long long nerf_point_mlp_fwd_stage(long long M, int D) {
  if (M <= 0) return 0;
  switch (D) {
    case 1024:
      return point_stage_bytes<1024>(M);
    case 896:
      return point_stage_bytes<896>(M);
    case 768:
      return point_stage_bytes<768>(M);
    case 640:
      return point_stage_bytes<640>(M);
    case 512:
    case 384:
    case 256:
    case 128:
      return 0;
    default:
      return -1;
  }
}

// The check build: nerf_point_mlp_fwd, which also writes the X operands (pe,
// x0..x7, feat, de) of every point to `xops` in the dW kernel's tiled layout
// (fused_mlp.tile_operand, the operands one after the other, ceil(M / 128)
// row tiles each), as K6 full hands them to the dW kernel. For checks only:
// no main path calls it.
extern "C" int nerf_point_mlp_fwd_operands(const float* pts, const float* dirs,
                                           const void* tiles, const void* const* biases,
                                           float* rgb, float* density, void* stage, void* xops,
                                           long long M, int D, int occ_softplus,
                                           int head_dist_alpha, void* stream) {
  if (xops == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return point_fwd_entry<true>(pts, dirs, tiles, biases, rgb, density, stage,
                               static_cast<unsigned char*>(xops), M, D, occ_softplus,
                               head_dist_alpha, stream);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
