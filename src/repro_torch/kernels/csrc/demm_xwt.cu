// demm_xwt: y = x @ W_sparse^T from the row-packed {values, indices} stream.
//
// Replaces the TPU kernel `demm_xwT_pallas` (body `_xwT_kernel`) of the JAX
// package's kernels/demm_spmm.py.  See demm_xwt_common.cuh for the arithmetic,
// the work split and what bounds it on an H100 (the packed bytes over
// device-memory bandwidth).
//
// Plain C interface, loaded with ctypes.  The launcher never synchronises and
// allocates nothing; it returns cudaGetLastError() (0 on success) or a
// negative code for arguments the kernel does not take.

#include "demm_xwt_common.cuh"

namespace {

template <typename XT>
int launch_values(const XT* x, const void* values, int v_dtype, const int32_t* indices,
                  float* y, int bx, int k, int o, int g, int m, int ne, int duplicates,
                  int rows_per_block, cudaStream_t stream) {
  if (v_dtype == demm::kFloat32) {
    demm::FloatWeights<XT, float> w{static_cast<const float*>(values)};
    return demm::launch_xt<XT>(x, w, indices, y, bx, k, o, g, m, ne, duplicates,
                               rows_per_block, stream);
  }
  if (v_dtype == demm::kBFloat16) {
    demm::FloatWeights<XT, __nv_bfloat16> w{static_cast<const __nv_bfloat16*>(values)};
    return demm::launch_xt<XT>(x, w, indices, y, bx, k, o, g, m, ne, duplicates,
                               rows_per_block, stream);
  }
  return demm::kErrBadDtype;
}

}  // namespace

extern "C" int demm_xwt_launch(const void* x, const void* values, const int32_t* indices,
                               float* y, int bx, int k, int o, int g, int m, int ne,
                               int x_dtype, int v_dtype, int duplicates, int rows_per_block,
                               int device, void* stream) {
  if (!demm::shapes_ok(bx, k, o, g, m, ne, rows_per_block)) return demm::kErrBadShape;
  demm::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == demm::kFloat32)
    return launch_values<float>(static_cast<const float*>(x), values, v_dtype, indices, y,
                                bx, k, o, g, m, ne, duplicates, rows_per_block, s);
  if (x_dtype == demm::kBFloat16)
    return launch_values<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), values,
                                        v_dtype, indices, y, bx, k, o, g, m, ne, duplicates,
                                        rows_per_block, s);
  return demm::kErrBadDtype;
}
