// demm_spmm_tc: K5 `demm_spmm` on the tiled tensor-core body, for a bfloat16
// B (K, Cd) of many columns whose rows are contiguous and 16-byte aligned.
//
// Replaces the TPU kernel `demm_spmm_pallas` (body `_spmm_kernel`) of the JAX
// package's kernels/demm_spmm.py; see demm_spmm_tc.cuh for the design and
// what bounds it on an H100.  Every other B (float32, few columns, strided or
// misaligned rows) takes the gather body through demm_block_spmm_launch; the
// caller picks (kernels/demm_spmm.spmm_body).
//
// Plain C interface, loaded with ctypes.  The launcher builds the tensor maps
// of B, the values and the indices on the host (cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point, so the library does not
// link libcuda), never synchronises and
// allocates nothing; it returns cudaGetLastError() (0 on success) or a
// negative code for arguments the kernel does not take.

#include "demm_spmm_tc.cuh"

namespace {

constexpr int kErrTensorMap = -4;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) matrix with a row stride of `stride` bytes, cut
// in boxes of box_cols x box_rows; out-of-bounds elements read as zeros.
bool tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long rows,
                   long long cols, long long stride, int box_cols, int box_rows,
                   CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int WGS>
int launch_tc(const void* b, long long s_bk, const void* values, const int32_t* indices,
              float* c, demm::SpmmTcGeom geo, int ng, int stages, cudaStream_t stream) {
  constexpr int BM = 64 * WGS;
  const int vbytes = geo.v_bf16 ? 2 : 4;
  auto kernel = demm::spmm_tc_kernel<BN, WGS>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= demm::kMaxDevices) return demm::kErrBadShape;
  const int smem_limit = demm::device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(dev);
  const int smem_sm = demm::device_attr<cudaDevAttrMaxSharedMemoryPerMultiprocessor>(dev);
  const long long row_tiles = (geo.r + 64LL * WGS - 1) / (64LL * WGS);
  const int col_tiles = (geo.cd + BN - 1) / BN;
  if (ng == 0)
    ng = demm::tc_auto_groups(geo.m, geo.groups, geo.ne, vbytes, BN, WGS, stages, smem_limit,
                              row_tiles * col_tiles,
                              demm::device_attr<cudaDevAttrMultiProcessorCount>(dev));
  if (ng < 1 || ng > geo.groups || demm::tc_pair_cols(ng * geo.ne, 2) > 256 ||
      (ng > 1 && (geo.m % 16 != 0 || ng * geo.m > demm::kTcMaxK)))
    return demm::kErrBadShape;
  geo.ng = ng;
  geo.kst = demm::tc_kst(geo.m, ng);
  geo.vbox = demm::tc_pair_cols(ng * geo.ne, vbytes);
  geo.ibox = demm::tc_pair_cols(ng * geo.ne, 4);
  if (stages == 0)
    stages = demm::tc_auto_stages(BN, WGS, geo.kst, ng, geo.ne, vbytes, smem_limit, smem_sm);
  if (stages < 2) return demm::kErrGroupTooWide;
  const size_t smem = demm::tc_smem_bytes(BN, WGS, geo.kst, stages, ng, geo.ne, vbytes);
  if (smem > static_cast<size_t>(smem_limit)) return demm::kErrGroupTooWide;
  geo.stages = stages;
  static int opted_in[demm::kMaxDevices] = {0};
  if (static_cast<int>(smem) > opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = static_cast<int>(smem);
  }
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return demm::kErrBadShape;
  // B (K, Cd): boxes of 64 columns x the stage's K rows, 128-byte swizzle
  // (the layout wgmma reads an N-major operand from); values and indices
  // (R, G x Ne): boxes of a stage's pairs x the tile's rows
  const long long pairs = static_cast<long long>(geo.groups) * geo.ne;
  CUtensorMap b_map, v_map, i_map;
  if (!tensor_map_2d(&b_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, geo.groups * geo.m, geo.cd,
                     s_bk * 2, 64, ng == 1 ? geo.m : geo.kst, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&v_map,
                     geo.v_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     values, geo.r, pairs, pairs * vbytes, geo.vbox, BM,
                     CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map_2d(&i_map, CU_TENSOR_MAP_DATA_TYPE_INT32, indices, geo.r, pairs, pairs * 4,
                     geo.ibox, BM, CU_TENSOR_MAP_SWIZZLE_NONE))
    return kErrTensorMap;
  dim3 grid(static_cast<unsigned>(row_tiles), col_tiles);
  demm::last_launch_smem = static_cast<int>(smem);
  kernel<<<grid, 128 * (WGS + 1), smem, stream>>>(b_map, v_map, i_map, c, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// duplicates: 0 promises that no group holds two non-zero slots at one
// index (their values are then stored without the summing search).
// tile_n: 128 or 256 columns per thread block, warpgroups: 1 or 2 (64 rows
// each), groups_per_stage: 1.. (more than 1 only when M is a multiple of 16,
// at most 256 K rows), stages: 2..4; 0 leaves each to the launcher.  The
// choice of this body over the gather body is the caller's
// (kernels/demm_spmm.spmm_body states it); the checks below only assert the
// terms of the tensor maps, refusing with a negative code what the body
// cannot take.
extern "C" int demm_spmm_tc_launch(const void* values, int v_dtype, const int32_t* indices,
                                   const void* b, float* c, int r, int k, int cd, int m, int ne,
                                   long long s_bk, long long s_cr, long long s_cc, int duplicates,
                                   int tile_n, int warpgroups, int groups_per_stage, int stages,
                                   int device, void* stream) {
  if (v_dtype != demm::kFloat32 && v_dtype != demm::kBFloat16) return demm::kErrBadDtype;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // rows of B, values and indices: 16-byte aligned (the tensor maps' terms)
  const long long pairs = static_cast<long long>(k / (m > 0 ? m : 1)) * ne;
  if (r < 1 || cd < 1 || m < 1 || m > demm::kTcMaxM || k < m || k % m != 0 || ne < 1 ||
      ne > m || ne > demm::kTcMaxNe || s_bk < cd || (s_bk * 2) % 16 != 0 || !aligned(b) ||
      !aligned(values) || !aligned(indices) || (pairs * 4) % 16 != 0 ||
      (v_dtype == demm::kBFloat16 && (pairs * 2) % 16 != 0) || s_cr < 0 || s_cc < 0 ||
      (tile_n != 0 && tile_n != 128 && tile_n != 256) || warpgroups < 0 || warpgroups > 2 ||
      stages < 0 || stages > 4 || stages == 1 || groups_per_stage < 0)
    return demm::kErrBadShape;
  demm::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  demm::SpmmTcGeom geo{r, cd, k / m, m, ne, 0, 0, 0, 0, 0, s_cr, s_cc,
                       s_cc == 1 && s_cr % 2 == 0 && reinterpret_cast<uintptr_t>(c) % 8 == 0,
                       v_dtype == demm::kBFloat16, duplicates != 0};
  if (tile_n == 0 || warpgroups == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= demm::kMaxDevices) return demm::kErrBadShape;
    const int sms = demm::device_attr<cudaDevAttrMultiProcessorCount>(dev);
    if (sms <= 0) return demm::kErrBadShape;
    int bn = 0, wgs = 0;
    demm::tc_auto_tile(r, cd, sms, &bn, &wgs);
    if (tile_n == 0) tile_n = bn;
    if (warpgroups == 0) warpgroups = wgs;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ng = groups_per_stage;
  if (tile_n == 128 && warpgroups == 1)
    return launch_tc<128, 1>(b, s_bk, values, indices, c, geo, ng, stages, s);
  if (tile_n == 128) return launch_tc<128, 2>(b, s_bk, values, indices, c, geo, ng, stages, s);
  if (warpgroups == 1) return launch_tc<256, 1>(b, s_bk, values, indices, c, geo, ng, stages, s);
  return launch_tc<256, 2>(b, s_bk, values, indices, c, geo, ng, stages, s);
}
