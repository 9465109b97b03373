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
// Two bodies.  At serving batch in the block layout (B = x^T, Cd <= 8) the
// bulk-copy cluster body of demm_block_cluster.cuh, as K4 runs it: a
// cluster of CTAs per row block, each CTA's contiguous slice of values and
// indices requested with bulk copies at entry, each CTA staging only its
// own groups' x segments with 16-byte loads, the partial tiles added through
// distributed shared memory.  Otherwise (and always for the row-packed
// layout) the gather body of demm_block_spmm_common.cuh.  The caller picks
// (`cluster`: 0 the gather body, -1 the cluster body with its size left to
// the launcher, 1..8 the cluster body with that many CTAs per row block;
// kernels/demm_block_spmm.block_body states the rule).  Both are bound on an
// H100 by the packed bytes over device-memory bandwidth.  B and C are read
// and written through the strides given, so the serving caller passes
// B = x^T and C = y^T as views.
//
// Plain C interface, loaded with ctypes.  The launcher never synchronises and
// allocates nothing; it returns cudaGetLastError() (0 on success) or a
// negative code for arguments the kernel does not take.

#include "demm_block_cluster.cuh"

namespace {

template <typename XT, typename W>
int launch_body(const int32_t* ag, W w, const int32_t* indices, const XT* b, float* c,
                const demm::BlockGeom& geo, int duplicates, int rows_per_block, int cluster,
                cudaStream_t stream) {
  if (cluster == 0)
    return demm::launch_block<XT>(ag, w, indices, b, c, geo, duplicates, rows_per_block,
                                  stream);
  // The cluster body reads the block layout's contiguous strides only.
  demm::ClusterGeom cg{geo.r,    geo.cd, geo.groups, geo.a_max, geo.block_r, geo.m, geo.ne,
                       geo.s_bc, geo.s_cr, geo.s_cc, cluster, 0, 0, 0,
                       demm::kThreads / geo.block_r};
  if (ag == nullptr || !geo.rows_fastest || geo.s_row != geo.ne ||
      geo.s_j != static_cast<long long>(geo.block_r) * geo.ne ||
      geo.s_rb != static_cast<long long>(geo.a_max) * geo.s_j || geo.s_bk != 1 ||
      cluster > 8 || cluster < -1 ||
      !demm::cluster_takes<XT, W>(cg, w.value_bytes(), indices, nullptr, b))
    return demm::kErrBadShape;
  if (cluster < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= demm::kMaxDevices) return demm::kErrBadShape;
    const int sms = demm::device_attr<cudaDevAttrMultiProcessorCount>(dev);
    if (sms <= 0) return demm::kErrBadShape;
    cg.csize = demm::cl_auto_csize(geo.r / geo.block_r, geo.a_max, sms);
  }
  return demm::launch_cluster<XT>(ag, w, indices, b, c, cg, duplicates, stream);
}

template <typename XT>
int launch_values(const int32_t* ag, const void* values, int v_dtype, const int32_t* indices,
                  const XT* b, float* c, const demm::BlockGeom& geo, int duplicates,
                  int rows_per_block, int cluster, cudaStream_t stream) {
  if (v_dtype == demm::kFloat32) {
    demm::FloatWeights<XT, float> w{static_cast<const float*>(values)};
    return launch_body<XT>(ag, w, indices, b, c, geo, duplicates, rows_per_block, cluster,
                           stream);
  }
  if (v_dtype == demm::kBFloat16) {
    demm::FloatWeights<XT, __nv_bfloat16> w{static_cast<const __nv_bfloat16*>(values)};
    return launch_body<XT>(ag, w, indices, b, c, geo, duplicates, rows_per_block, cluster,
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
    int duplicates, int rows_per_block, int cluster, int device, void* stream) {
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
                                rows_per_block, cluster, s);
  if (b_dtype == demm::kBFloat16)
    return launch_values<__nv_bfloat16>(active_groups, values, v_dtype, indices,
                                        static_cast<const __nv_bfloat16*>(b), c, geo,
                                        duplicates, rows_per_block, cluster, s);
  return demm::kErrBadDtype;
}
