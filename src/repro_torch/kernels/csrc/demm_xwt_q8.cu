// demm_xwt_q8: y = x @ W_q8^T with int8 packed values dequantised in-register.
//
// Replaces the TPU kernel `demm_xwT_q8_pallas` (body `_xwT_q8_kernel`) of the
// JAX package's kernels/demm_q8.py.  Only the int8 values, the int32 indices
// and the float32 scales cross device memory; no dequantised copy of W is
// written.  scale_cols == 1 reads scales (O,) per output row, scale_cols == G
// reads scales (O, G) per (row, group).  Two bodies, as K1's
// (demm_xwt.cu), both bound on an H100 by the packed bytes over
// device-memory bandwidth (int8 values cut them from 8 to 5 per pair):
//   * at serving batch (Bx <= 8) the bulk-copy row-tile body of
//     demm_xwt_bulk.cuh with Int8BulkWeights: about one CTA per SM, each
//     CTA's values and indices -- and per-group scales -- requested with bulk
//     copies at entry, x staged once per CTA; a per-row scale is read once
//     per row pass into a register, a per-group one from shared memory;
//   * otherwise the gather body of demm_xwt_common.cuh with Int8Weights.
// The caller picks (`bulk`: 0 the gather body, 1 the bulk body;
// kernels/demm_xwT.xwt_body states the rule).  `rows_per_block` is the rows
// of a gather block or of a bulk CTA, `chunks` the bulk body's row chunks
// per CTA, `lanes` its slot lanes per row, 8 or 16 (0 for any of them: the
// launcher's choice).
//
// Plain C interface, loaded with ctypes.  The launcher never synchronises and
// allocates nothing; it returns cudaGetLastError() (0 on success) or a
// negative code for arguments the kernel does not take.

#include "demm_xwt_bulk.cuh"

namespace {

template <typename XT>
int launch_body(const XT* x, const int8_t* values, const int32_t* indices,
                const float* scales, float* y, int bx, int k, int o, int g, int m, int ne,
                int scale_cols, int duplicates, int rows_per_block, int bulk, int chunks,
                int lanes, cudaStream_t stream) {
  if (bulk == 0) {
    demm::Int8Weights<XT> w{values, scales, scale_cols};
    return demm::launch_xt<XT>(x, w, indices, y, bx, k, o, g, m, ne, duplicates,
                               rows_per_block, stream);
  }
  if (bulk != 1) return demm::kErrBadShape;
  demm::BulkGeom geo{bx, k, o, g, m, ne, rows_per_block, 0, 0};
  // slot lanes per row: 8 or 16, chosen at each launch
  if (scale_cols == 1)
    return demm::launch_bulk<XT, 0>(x, demm::Int8BulkWeights<XT, false>{values, scales},
                                    indices, y, geo, duplicates, chunks, lanes, stream);
  return demm::launch_bulk<XT, 0>(x, demm::Int8BulkWeights<XT, true>{values, scales}, indices,
                                  y, geo, duplicates, chunks, lanes, stream);
}

}  // namespace

extern "C" int demm_xwt_q8_launch(const void* x, const int8_t* values,
                                  const int32_t* indices, const float* scales, float* y,
                                  int bx, int k, int o, int g, int m, int ne, int x_dtype,
                                  int scale_cols, int duplicates, int rows_per_block,
                                  int bulk, int chunks, int lanes, int device,
                                  void* stream) {
  if (!demm::shapes_ok(bx, k, o, g, m, ne, rows_per_block)) return demm::kErrBadShape;
  if (scale_cols != 1 && scale_cols != g) return demm::kErrBadShape;
  demm::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == demm::kFloat32)
    return launch_body<float>(static_cast<const float*>(x), values, indices, scales, y, bx, k,
                              o, g, m, ne, scale_cols, duplicates, rows_per_block, bulk,
                              chunks, lanes, s);
  if (x_dtype == demm::kBFloat16)
    return launch_body<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), values, indices,
                                      scales, y, bx, k, o, g, m, ne, scale_cols, duplicates,
                                      rows_per_block, bulk, chunks, lanes, s);
  return demm::kErrBadDtype;
}
