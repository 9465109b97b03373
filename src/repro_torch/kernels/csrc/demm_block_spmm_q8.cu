// demm_block_spmm_q8: C = A_q8 @ B from the two-level block layout with int8
// values dequantised in-register.
//
// Replaces the TPU kernel `demm_block_spmm_q8_pallas` (body `_block_q8_kernel`)
// of the JAX package's kernels/demm_q8.py.  One float32 scale per (row block,
// list slot, row), scales (RB, A_max, block_r), multiplies the row's summed
// int8 scatter values; the active-group address stream is the float kernel's.
// Only int8 values, int32 indices, the group ids and the scales cross device
// memory.  Two bodies:
//   * at serving batch (B = x^T, Cd <= 8) the bulk-copy cluster body of
//     demm_block_cluster.cuh: a cluster of CTAs per row block, each CTA's
//     contiguous slice of values / indices / scales and the x segments of its
//     own groups requested at entry with bulk copies, the partial tiles added
//     through distributed shared memory;
//   * otherwise the gather body of demm_block_spmm_common.cuh (K2's).
// The caller picks (`cluster`: 0 the gather body, -1 the cluster body with
// its size left to the launcher, 1..8 the cluster body with that many CTAs
// per row block); both say what bounds them on an H100.
//
// Plain C interface, loaded with ctypes.  The launcher never synchronises and
// allocates nothing; it returns cudaGetLastError() (0 on success) or a
// negative code for arguments the kernel does not take.

#include "demm_block_cluster.cuh"

namespace {

template <typename XT>
int launch_q8(const int32_t* ag, const int8_t* values, const int32_t* indices,
              const float* scales, const XT* b, float* c, const demm::BlockGeom& geo,
              int duplicates, int rows_per_block, int cluster, cudaStream_t stream) {
  demm::Int8Weights<XT> w{values, scales, 1};
  if (cluster == 0)
    return demm::launch_block<XT>(ag, w, indices, b, c, geo, duplicates, rows_per_block,
                                  stream);
  demm::ClusterGeom cg{geo.r,    geo.cd, geo.groups, geo.a_max, geo.block_r, geo.m, geo.ne,
                       geo.s_bc, geo.s_cr, geo.s_cc, cluster, 0, 0, 0,
                       demm::kThreads / geo.block_r};
  if (geo.s_bk != 1 || cluster > 8 || cluster < -1 ||
      !demm::cluster_takes<XT, demm::Int8Weights<XT>>(cg, values, indices, scales, b))
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

}  // namespace

extern "C" int demm_block_spmm_q8_launch(
    const int32_t* active_groups, const int8_t* values, const int32_t* indices,
    const float* scales, const void* b, float* c, int r, int k, int cd, int rb, int a_max,
    int block_r, int m, int ne, long long s_bk, long long s_bc, long long s_cr,
    long long s_cc, int b_dtype, int duplicates, int rows_per_block, int cluster,
    int device, void* stream) {
  demm::BlockGeom geo;
  const long long s_row = ne;
  const long long s_j = static_cast<long long>(block_r) * ne;
  const long long s_rb = static_cast<long long>(a_max) * s_j;
  if (active_groups == nullptr || scales == nullptr ||
      !demm::make_block_geom(&geo, r, k, cd, rb, a_max, block_r, m, ne, s_rb, s_j, s_row,
                             s_bk, s_bc, s_cr, s_cc, /*rows_fastest=*/1) ||
      rows_per_block < 0)
    return demm::kErrBadShape;
  demm::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_dtype == demm::kFloat32)
    return launch_q8<float>(active_groups, values, indices, scales, static_cast<const float*>(b),
                            c, geo, duplicates, rows_per_block, cluster, s);
  if (b_dtype == demm::kBFloat16)
    return launch_q8<__nv_bfloat16>(active_groups, values, indices, scales,
                                    static_cast<const __nv_bfloat16*>(b), c, geo, duplicates,
                                    rows_per_block, cluster, s);
  return demm::kErrBadDtype;
}
