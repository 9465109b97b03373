// demm_block_spmm: C = A_sparse @ B with float packed values, in two layouts.
//
//   * the two-level block layout (active_groups (RB, A_max), values/indices
//     (RB, A_max, block_r, Ne)): replaces the TPU kernel
//     `demm_block_spmm_pallas` (body `_block_spmm_kernel`) of the JAX
//     package's kernels/demm_block_spmm.py, whose B tile address came from the
//     scalar-prefetched group id; here the thread block reads the id itself
//     and stages only the listed groups' rows of B;
//   * the row-packed layout (values/indices (R, G, Ne)) with the identity
//     address stream (active_groups == null): replaces `demm_spmm_pallas`
//     (body `_spmm_kernel`) of kernels/demm_spmm.py.
//
// See demm_block_spmm_common.cuh for the arithmetic, the work split and what
// bounds it on an H100.  B and C are read and written through the strides
// given, so the serving caller passes B = x^T and C = y^T as views.
//
// Plain C interface, loaded with ctypes.  The launcher never synchronises and
// allocates nothing; it returns cudaGetLastError() (0 on success) or a
// negative code for arguments the kernel does not take.

#include "demm_block_spmm_common.cuh"

namespace {

template <typename XT>
int launch_values(const int32_t* ag, const void* values, int v_dtype, const int32_t* indices,
                  const XT* b, float* c, const demm::BlockGeom& geo, int duplicates,
                  int rows_per_block, cudaStream_t stream) {
  if (v_dtype == demm::kFloat32) {
    demm::FloatWeights<XT, float> w{static_cast<const float*>(values)};
    return demm::launch_block<XT>(ag, w, indices, b, c, geo, duplicates, rows_per_block,
                                  stream);
  }
  if (v_dtype == demm::kBFloat16) {
    demm::FloatWeights<XT, __nv_bfloat16> w{static_cast<const __nv_bfloat16*>(values)};
    return demm::launch_block<XT>(ag, w, indices, b, c, geo, duplicates, rows_per_block,
                                  stream);
  }
  return demm::kErrBadDtype;
}

}  // namespace

extern "C" int demm_block_spmm_launch(
    const int32_t* active_groups, const void* values, const int32_t* indices, const void* b,
    float* c, int r, int k, int cd, int rb, int a_max, int block_r, int m, int ne,
    long long s_rb, long long s_j, long long s_row, long long s_bk, long long s_bc,
    long long s_cr, long long s_cc, int rows_fastest, int b_dtype, int v_dtype,
    int duplicates, int rows_per_block, int device, void* stream) {
  demm::BlockGeom geo;
  if (!demm::make_block_geom(&geo, r, k, cd, rb, a_max, block_r, m, ne, s_rb, s_j, s_row,
                             s_bk, s_bc, s_cr, s_cc, rows_fastest) ||
      rows_per_block < 0)
    return demm::kErrBadShape;
  demm::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_dtype == demm::kFloat32)
    return launch_values<float>(active_groups, values, v_dtype, indices,
                                static_cast<const float*>(b), c, geo, duplicates,
                                rows_per_block, s);
  if (b_dtype == demm::kBFloat16)
    return launch_values<__nv_bfloat16>(active_groups, values, v_dtype, indices,
                                        static_cast<const __nv_bfloat16*>(b), c, geo,
                                        duplicates, rows_per_block, s);
  return demm::kErrBadDtype;
}
