// The weight-gradient kernel of dw_sm90.cuh on its own: dW = X^T G for a
// table of blocks, for the checks and timings that hold it against its plain
// version (ops/fused_mlp.py::dw_plain). The backward kernels launch the same
// code from their own C entries (point_mlp_bwd.cu).

#include "dw_sm90.cuh"

// C interface, bound with ctypes by nope_nerf_torch/ops/fused_mlp.py.
// For block i < n: x[i], g[i] the tiled bf16 operands (16-byte aligned,
// xblocks[i] and N[i] / 64 column blocks per row tile), dst[i] its (K[i],
// N[i]) f32 result. partials: chunks x sum(K[i] N[i]) f32 (scratch). Returns
// a cudaError_t (0 on success); the launches are asynchronous on `stream`.
extern "C" int nerf_dw_sm90(int n, const void* const* x, const void* const* g, void* const* dst,
                            const int* xblocks, const int* K, const int* N, long long M,
                            int chunks, float* partials, void* stream) {
  if (n <= 0 || n > kDwMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  DwTable tab;
  tab.n = n;
  for (int i = 0; i < n; ++i) {
    tab.b[i].x = static_cast<const unsigned char*>(x[i]);
    tab.b[i].g = static_cast<const unsigned char*>(g[i]);
    tab.b[i].dst = static_cast<float*>(dst[i]);
    tab.b[i].xblocks = xblocks[i];
    tab.b[i].gblocks = N[i] / 64;
    tab.b[i].K = K[i];
    tab.b[i].N = N[i];
  }
  return static_cast<int>(
      dw_sm90_launch(tab, M, chunks, partials, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
