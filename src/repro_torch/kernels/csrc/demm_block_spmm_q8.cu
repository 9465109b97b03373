// demm_block_spmm_q8: C = A_q8 @ B from the two-level block layout with int8
// values dequantised in-register.
//
// Replaces the TPU kernel `demm_block_spmm_q8_pallas` (body `_block_q8_kernel`)
// of the JAX package's kernels/demm_q8.py.  One float32 scale per (row block,
// list slot, row), scales (RB, A_max, block_r), multiplies the row's summed
// int8 scatter values; the active-group address stream is the float kernel's.
// Only int8 values, int32 indices, the group ids and the scales cross device
// memory.  See demm_block_spmm_common.cuh for the arithmetic, the work split
// and what bounds it on an H100.
//
// Plain C interface, loaded with ctypes.  The launcher never synchronises and
// allocates nothing; it returns cudaGetLastError() (0 on success) or a
// negative code for arguments the kernel does not take.

#include "demm_block_spmm_common.cuh"

extern "C" int demm_block_spmm_q8_launch(
    const int32_t* active_groups, const int8_t* values, const int32_t* indices,
    const float* scales, const void* b, float* c, int r, int k, int cd, int rb, int a_max,
    int block_r, int m, int ne, long long s_bk, long long s_bc, long long s_cr,
    long long s_cc, int b_dtype, int duplicates, int rows_per_block, int device,
    void* stream) {
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
  if (b_dtype == demm::kFloat32) {
    demm::Int8Weights<float> w{values, scales, 1};
    return demm::launch_block<float>(active_groups, w, indices, static_cast<const float*>(b),
                                     c, geo, duplicates, rows_per_block, s);
  }
  if (b_dtype == demm::kBFloat16) {
    demm::Int8Weights<__nv_bfloat16> w{values, scales, 1};
    return demm::launch_block<__nv_bfloat16>(active_groups, w, indices,
                                             static_cast<const __nv_bfloat16*>(b), c, geo,
                                             duplicates, rows_per_block, s);
  }
  return demm::kErrBadDtype;
}
