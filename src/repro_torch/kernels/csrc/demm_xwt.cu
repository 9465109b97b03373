// demm_xwt: y = x @ W_sparse^T from the row-packed {values, indices} stream.
//
// Replaces the TPU kernel `demm_xwT_pallas` (body `_xwT_kernel`) of the JAX
// package's kernels/demm_spmm.py.  Three bodies:
//   * at serving batch (Bx <= 8) the bulk-copy row-tile body of
//     demm_xwt_bulk.cuh, bound on an H100 by the packed bytes over
//     device-memory bandwidth: about one CTA per SM, each CTA's contiguous
//     tile of values and indices requested with bulk copies at entry, x
//     staged once per CTA with 16-byte loads;
//   * at wider bfloat16 x (Bx > 8: prefill chunks, whole-sequence prefill,
//     the packed training forward) the wide body of demm_xwt_wide.cuh: about
//     one CTA per SM, each decoding its rows' pairs once into shared memory
//     and walking x's row tiles of 32-128 rows over them;
//   * otherwise (float32 x, shapes the others refuse) the gather body of
//     demm_xwt_common.cuh (many small blocks, each staging its x tile, warps
//     striding over a row's pairs).
// `ne` is the slots read per group and `ne_stride` the slots stored per group
// (the pitch of the values and indices): a tier view -- the draft tier of
// self-speculative decoding -- reads the first ne of every ne_stride slots in
// place; the full tier is ne == ne_stride.
// The caller picks (`body`: 0 the gather body, 1 the bulk body, 2 the wide
// body; kernels/demm_xwT.xwt_body states the rule).  `rows_per_block` is the
// rows of a gather block or of a bulk or wide CTA, `chunks` the bulk body's
// row chunks per CTA, `tile` the wide body's x rows per tile (0 for any of
// them: the launcher's choice).
//
// Plain C interface, loaded with ctypes.  The launcher never synchronises and
// allocates nothing; it returns cudaGetLastError() (0 on success) or a
// negative code for arguments the kernel does not take.

#include <type_traits>

#include "demm_xwt_bulk.cuh"
#include "demm_xwt_wide.cuh"

namespace {

template <typename XT, typename W>
int launch_body(const XT* x, W w, const int32_t* indices, float* y, int bx, int k, int o,
                int g, int m, int ne, int pitch, int duplicates, int rows_per_block,
                int body, int chunks, int tile, cudaStream_t stream) {
  if (body == 0)
    return demm::launch_xt<XT>(x, w, indices, y, bx, k, o, g, m, ne, pitch, duplicates,
                               rows_per_block, stream);
  if (body == 2) {
    if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
      demm::WideGeom geo{bx, k, o, g, m, ne, pitch, rows_per_block, 0, 0, 0};
      return demm::launch_wide(x, w, indices, y, geo, duplicates, tile, stream);
    }
    return demm::kErrBadShape;   // float32 x: the gather body
  }
  if (body != 1) return demm::kErrBadShape;
  demm::BulkGeom geo{bx, k, o, g, m, ne, pitch, rows_per_block, 0, 0};
  // 16 slot lanes (a half warp) a row at every tile
  return demm::launch_bulk<XT, 16>(x, w, indices, y, geo, duplicates, chunks, 0, stream);
}

template <typename XT>
int launch_values(const XT* x, const void* values, int v_dtype, const int32_t* indices,
                  float* y, int bx, int k, int o, int g, int m, int ne, int pitch,
                  int duplicates, int rows_per_block, int body, int chunks, int tile,
                  cudaStream_t stream) {
  if (v_dtype == demm::kFloat32) {
    demm::FloatWeights<XT, float> w{static_cast<const float*>(values)};
    return launch_body<XT>(x, w, indices, y, bx, k, o, g, m, ne, pitch, duplicates,
                           rows_per_block, body, chunks, tile, stream);
  }
  if (v_dtype == demm::kBFloat16) {
    demm::FloatWeights<XT, __nv_bfloat16> w{static_cast<const __nv_bfloat16*>(values)};
    return launch_body<XT>(x, w, indices, y, bx, k, o, g, m, ne, pitch, duplicates,
                           rows_per_block, body, chunks, tile, stream);
  }
  return demm::kErrBadDtype;
}

}  // namespace

extern "C" int demm_xwt_launch(const void* x, const void* values, const int32_t* indices,
                               float* y, int bx, int k, int o, int g, int m, int ne,
                               int ne_stride, int x_dtype, int v_dtype, int duplicates,
                               int rows_per_block, int body, int chunks, int tile,
                               int device, void* stream) {
  if (!demm::shapes_ok(bx, k, o, g, m, ne, ne_stride, rows_per_block))
    return demm::kErrBadShape;
  demm::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == demm::kFloat32)
    return launch_values<float>(static_cast<const float*>(x), values, v_dtype, indices, y,
                                bx, k, o, g, m, ne, ne_stride, duplicates, rows_per_block,
                                body, chunks, tile, s);
  if (x_dtype == demm::kBFloat16)
    return launch_values<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), values,
                                        v_dtype, indices, y, bx, k, o, g, m, ne, ne_stride,
                                        duplicates, rows_per_block, body, chunks, tile, s);
  return demm::kErrBadDtype;
}

// The dynamic shared memory (bytes) of the last DeMM kernel this library
// launched (demm_empty_launch's not included).
extern "C" int demm_last_launch_smem() { return demm::last_launch_smem; }

// The launch floor: an empty kernel on `blocks` CTAs of `threads` threads in
// clusters of `cluster`, with `smem` bytes of dynamic shared memory -- what a
// launch of that shape costs before any work is done.  A measurement aid
// (chip_smoke.py times it at K1's and K2's grids), not a serving path.
__global__ void __launch_bounds__(1024) demm_empty_kernel() {}

extern "C" int demm_empty_launch(int blocks, int threads, int cluster, int smem, int device,
                                 void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024 || cluster < 1 || cluster > 8 ||
      blocks % cluster || smem < 0)
    return demm::kErrBadShape;
  demm::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  static int opted_in[demm::kMaxDevices] = {0};   // as the kernels' launchers: once per size
  cudaError_t err = cudaSuccess;
  if (device < 0 || device >= demm::kMaxDevices) return demm::kErrBadShape;
  if (smem > opted_in[device]) {
    err = cudaFuncSetAttribute(demm_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;   // 1: a plain launch, as K1's
  err = cudaLaunchKernelEx(&cfg, demm_empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
