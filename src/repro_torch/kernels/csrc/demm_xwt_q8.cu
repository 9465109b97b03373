// demm_xwt_q8: y = x @ W_q8^T with int8 packed values dequantised in-register.
//
// Replaces the TPU kernel `demm_xwT_q8_pallas` (body `_xwT_q8_kernel`) of the
// JAX package's kernels/demm_q8.py.  Only the int8 values, the int32 indices
// and the float32 scales cross device memory; no dequantised copy of W is
// written.  scale_cols == 1 reads scales (O,) per output row, scale_cols == G
// reads scales (O, G) per (row, group).  Three bodies, as K1's
// (demm_xwt.cu); at serving batch bound on an H100 by the packed bytes over
// device-memory bandwidth (int8 values cut them from 8 to 5 per pair):
//   * at serving batch (Bx <= 8) the bulk-copy row-tile body of
//     demm_xwt_bulk.cuh with Int8BulkWeights: about one CTA per SM, each
//     CTA's values and indices -- and per-group scales -- requested with bulk
//     copies at entry, x staged once per CTA; a per-row scale is read once
//     per row pass into a register, a per-group one from shared memory;
//   * at wider bfloat16 x (Bx > 8) the wide body of demm_xwt_wide.cuh with
//     Int8Weights: each pair's weight -- the int8 value times its row's or
//     group's rounded scale, rounded -- decoded once per launch into shared
//     memory;
//   * otherwise the gather body of demm_xwt_common.cuh with Int8Weights.
// `ne` is the slots read per group and `ne_stride` the slots stored (the
// pitch), as for K1: a tier view reads a prefix of every group in place.
// The caller picks (`body`: 0 the gather body, 1 the bulk body, 2 the wide
// body; kernels/demm_xwT.xwt_body states the rule).  `rows_per_block` is the
// rows of a gather block or of a bulk or wide CTA, `chunks` the bulk body's
// row chunks per CTA, `lanes` its slot lanes per row, 8 or 16, `tile` the
// wide body's x rows per tile (0 for any of them: the launcher's choice).
//
// Plain C interface, loaded with ctypes.  The launcher never synchronises and
// allocates nothing; it returns cudaGetLastError() (0 on success) or a
// negative code for arguments the kernel does not take.

#include <type_traits>

#include "demm_xwt_bulk.cuh"
#include "demm_xwt_wide.cuh"

namespace {

template <typename XT>
int launch_body(const XT* x, const int8_t* values, const int32_t* indices,
                const float* scales, float* y, int bx, int k, int o, int g, int m, int ne,
                int pitch, int scale_cols, int duplicates, int rows_per_block, int body,
                int chunks, int lanes, int tile, cudaStream_t stream) {
  if (body == 0) {
    demm::Int8Weights<XT> w{values, scales, scale_cols};
    return demm::launch_xt<XT>(x, w, indices, y, bx, k, o, g, m, ne, pitch, duplicates,
                               rows_per_block, stream);
  }
  if (body == 2) {
    if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
      demm::WideGeom geo{bx, k, o, g, m, ne, pitch, rows_per_block, 0, 0, 0};
      return demm::launch_wide(x, demm::Int8Weights<XT>{values, scales, scale_cols}, indices,
                               y, geo, duplicates, tile, stream);
    }
    return demm::kErrBadShape;   // float32 x: the gather body
  }
  if (body != 1) return demm::kErrBadShape;
  demm::BulkGeom geo{bx, k, o, g, m, ne, pitch, rows_per_block, 0, 0};
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
                                  int bx, int k, int o, int g, int m, int ne,
                                  int ne_stride, int x_dtype, int scale_cols, int duplicates,
                                  int rows_per_block, int body, int chunks, int lanes,
                                  int tile, int device, void* stream) {
  if (!demm::shapes_ok(bx, k, o, g, m, ne, ne_stride, rows_per_block))
    return demm::kErrBadShape;
  if (scale_cols != 1 && scale_cols != g) return demm::kErrBadShape;
  demm::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == demm::kFloat32)
    return launch_body<float>(static_cast<const float*>(x), values, indices, scales, y, bx, k,
                              o, g, m, ne, ne_stride, scale_cols, duplicates, rows_per_block,
                              body, chunks, lanes, tile, s);
  if (x_dtype == demm::kBFloat16)
    return launch_body<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), values, indices,
                                      scales, y, bx, k, o, g, m, ne, ne_stride, scale_cols,
                                      duplicates, rows_per_block, body, chunks, lanes, tile,
                                      s);
  return demm::kErrBadDtype;
}
