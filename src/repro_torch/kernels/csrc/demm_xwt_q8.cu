// demm_xwt_q8: y = x @ W_q8^T with int8 packed values dequantised in-register.
//
// Replaces the TPU kernel `demm_xwT_q8_pallas` (body `_xwT_q8_kernel`) of the
// JAX package's kernels/demm_q8.py.  Only the int8 values, the int32 indices
// and the float32 scales cross device memory; no dequantised copy of W is
// written.  scale_cols == 1 reads scales (O,) per output row, scale_cols == G
// reads scales (O, G) per (row, group).  See demm_xwt_common.cuh for the
// arithmetic, the work split and what bounds it on an H100 (the packed bytes
// over device-memory bandwidth; int8 values cut them from 8 to 5 per pair).
//
// Plain C interface, loaded with ctypes.  The launcher never synchronises and
// allocates nothing; it returns cudaGetLastError() (0 on success) or a
// negative code for arguments the kernel does not take.

#include "demm_xwt_common.cuh"

extern "C" int demm_xwt_q8_launch(const void* x, const int8_t* values,
                                  const int32_t* indices, const float* scales, float* y,
                                  int bx, int k, int o, int g, int m, int ne, int x_dtype,
                                  int scale_cols, int duplicates, int rows_per_block,
                                  int device, void* stream) {
  if (!demm::shapes_ok(bx, k, o, g, m, ne, rows_per_block)) return demm::kErrBadShape;
  if (scale_cols != 1 && scale_cols != g) return demm::kErrBadShape;
  demm::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == demm::kFloat32) {
    demm::Int8Weights<float> w{values, scales, scale_cols};
    return demm::launch_xt<float>(static_cast<const float*>(x), w, indices, y, bx, k, o, g,
                                  m, ne, duplicates, rows_per_block, s);
  }
  if (x_dtype == demm::kBFloat16) {
    demm::Int8Weights<__nv_bfloat16> w{values, scales, scale_cols};
    return demm::launch_xt<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), w, indices,
                                          y, bx, k, o, g, m, ne, duplicates, rows_per_block,
                                          s);
  }
  return demm::kErrBadDtype;
}
