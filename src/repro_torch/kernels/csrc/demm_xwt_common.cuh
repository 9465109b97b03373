// Shared body of the packed y = x @ W_sparse^T kernels (float and int8 values).
//
// What is computed (gather form of the DeMM read ports):
//
//   y[b, o] = sum_g sum_n  w(o, g, n) * x[b, g*M + indices[o, g, n]]
//
// with w(o, g, n) the packed value rounded to the activation type (and, for
// int8 values, multiplied by its scale rounded to the activation type and
// rounded again), every product and the whole sum in float32, and the output
// in float32.  A padded slot is value 0 at index 0 and adds exactly 0.  The
// dense weight is never formed.
//
// A tier view (the draft tier of self-speculative decoding) reads only the
// first `ne` of the `pitch` slots stored per group: the operands are a prefix
// of a (O, G, pitch) stream, every group's slots `pitch` apart.  The full
// tier is pitch == ne.
//
// Duplicate indices (two slots of one group at one column) follow the TPU
// kernel's scatter matrix: their values are summed in the activation type, in
// slot order, before the one product with x (fold_slot below).  The FOLD
// template flag turns that on; a launch told that no group holds two non-zero
// slots at one index takes the FOLD = false instantiation, which is the same
// number with no per-slot search.
//
// Work split.  A block owns ROWS consecutive output rows `o` and a tile of BT
// activation rows `b`.  It stages the x tile in shared memory, transposed to
// [column][BT] in the activation type, so that one packed pair costs one
// shared load that serves all BT activation rows; meanwhile the first packed rows are
// prefetched into L2, since they do not depend on x.  Each warp then walks whole output rows:
// its 32 lanes stride over the row's G*Ne contiguous {value, index} pairs
// (coalesced global loads), accumulate BT float32 partial sums in registers,
// and a shuffle tree folds the lanes.  When the K x BT tile exceeds the shared
// memory a block may use, the groups are processed in chunks and the owning
// lane adds each chunk's partial sum to y (single owner, no atomics).
//
// Bound on this card: at decode batch sizes the work is one pass over the
// packed bytes (values + indices), so device-memory bandwidth is the limit;
// the arithmetic is a few FMAs per 8 bytes.  The design therefore spends its
// effort on reading each packed byte once, coalesced, and keeping x on chip.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace demm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Error codes returned by the launchers besides cudaError_t values (> 0).
constexpr int kErrBadDtype = -1;
constexpr int kErrBadShape = -2;
constexpr int kErrGroupTooWide = -3;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_float<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

// Round a float to the activation type XT and return it as a float again.
template <typename XT> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Weight policies: how packed slots become the float32 multiplicand.  raw() is
// one slot in the activation type (exact for int8), finish() applies what
// comes after the scatter: nothing for float values, the scale for int8.
template <typename XT, typename VT>
struct FloatWeights {
  const VT* values;
  static constexpr int kValueBytes = sizeof(VT);
  __host__ __device__ __forceinline__ const char* value_bytes() const {
    return reinterpret_cast<const char*>(values);
  }
  __device__ __forceinline__ float raw(size_t slot) const {
    return round_to<XT>(to_float<VT>(values[slot]));
  }
  __device__ __forceinline__ float finish(float s, size_t /*scale_slot*/) const { return s; }
  // The same policy reading its values from elsewhere (a staged copy).
  static constexpr bool kHasScales = false;
  __device__ __forceinline__ const float* scale_ptr() const { return nullptr; }
  __device__ __forceinline__ FloatWeights on(const void* v, const float* /*scales*/) const {
    return {static_cast<const VT*>(v)};
  }
  // finish() split in two: the multiplier of a scale unit, read once, and
  // its application to one summed slot.
  __device__ __forceinline__ float scale_of(size_t /*scale_slot*/) const { return 1.f; }
  __device__ __forceinline__ float finish_with(float s, float /*scale*/) const { return s; }
  // finish(raw(slot)) for the xwT layout's slot of (row o, group g)
  __device__ __forceinline__ float load(size_t slot, int /*o*/, int /*g*/) const {
    return raw(slot);
  }
  __device__ __forceinline__ size_t xwt_scale(int /*o*/, int /*g*/) const { return 0; }
  // The bulk body's interface (demm_xwt_bulk.cuh): no scales to stage, none
  // per row, and a row view over the staged values.
  static constexpr int kStagedScaleBytes = 0;
  __host__ __device__ __forceinline__ const char* staged_scale_bytes() const { return nullptr; }
  __device__ __forceinline__ float row_scale(int /*o*/) const { return 1.f; }
  struct Row {
    const VT* values;
    __device__ __forceinline__ float raw(size_t slot) const {
      return round_to<XT>(to_float<VT>(values[slot]));
    }
    __device__ __forceinline__ float finish(float s, int /*g*/) const { return s; }
    // the four slots [slot, slot + 4), in groups g[0..3], with one vector
    // load (slot a multiple of 4, the values 16-byte aligned)
    __device__ __forceinline__ void load4(size_t slot, const int (&/*g*/)[4],
                                          float (&w)[4]) const {
      if constexpr (sizeof(VT) == 4) {
        const float4 v = *reinterpret_cast<const float4*>(values + slot);
        w[0] = round_to<XT>(v.x); w[1] = round_to<XT>(v.y);
        w[2] = round_to<XT>(v.z); w[3] = round_to<XT>(v.w);
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(values + slot);
        const VT* h = reinterpret_cast<const VT*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = round_to<XT>(to_float<VT>(h[j]));
      }
    }
  };
  __device__ __forceinline__ Row row(const void* v, const float* /*scales*/,
                                     float /*scale*/) const {
    return {static_cast<const VT*>(v)};
  }
};

template <typename XT>
struct Int8Weights {
  const int8_t* values;
  const float* scales;     // xwT: (O, scale_cols); block: (RB, A_max, block_r)
  int scale_cols;          // xwT only.  1: per output row; G: per (row, group)
  static constexpr int kValueBytes = 1;
  __host__ __device__ __forceinline__ const char* value_bytes() const {
    return reinterpret_cast<const char*>(values);
  }
  __device__ __forceinline__ float raw(size_t slot) const {
    return static_cast<float>(values[slot]);
  }
  __device__ __forceinline__ size_t xwt_scale(int o, int g) const {
    return static_cast<size_t>(o) * scale_cols + (scale_cols == 1 ? 0 : g);
  }
  // The (summed) int8 value times its scale rounded to the activation type,
  // the product rounded again, as the scatter tile of the TPU kernel is.
  __device__ __forceinline__ float finish(float s, size_t scale_slot) const {
    return round_to<XT>(s * round_to<XT>(scales[scale_slot]));
  }
  static constexpr bool kHasScales = true;
  __device__ __forceinline__ const float* scale_ptr() const { return scales; }
  __device__ __forceinline__ Int8Weights on(const void* v, const float* sc) const {
    return {static_cast<const int8_t*>(v), sc, scale_cols};
  }
  // finish(s, slot) == finish_with(s, scale_of(slot))
  __device__ __forceinline__ float scale_of(size_t scale_slot) const {
    return round_to<XT>(scales[scale_slot]);
  }
  __device__ __forceinline__ float finish_with(float s, float scale) const {
    return round_to<XT>(s * scale);
  }
  // finish(raw(slot)) for the xwT layout's slot of (row o, group g), the
  // scale read first
  __device__ __forceinline__ float load(size_t slot, int o, int g) const {
    const float s = round_to<XT>(scales[xwt_scale(o, g)]);
    return round_to<XT>(static_cast<float>(values[slot]) * s);
  }
};

// The xwT int8 policy of the bulk body (demm_xwt_bulk.cuh), its scale unit
// fixed at compile time so that the inner loop reads no scale from device
// memory: PER_GROUP (scales (O, G)) stages a chunk's rows x G scales in
// shared memory beside its pairs (kStagedScaleBytes per row and group), and a
// row view reads its group's scale there; per row (scales (O,)) the row's
// scale is read once per row pass (row_scale) and kept in a register.  The
// arithmetic is Int8Weights': the (summed) int8 value times its scale rounded
// to the activation type, the product rounded again.  The scale cannot be
// taken out of the row's sum, since the rounding is per weight.
template <typename XT, bool PER_GROUP>
struct Int8BulkWeights {
  const int8_t* values;
  const float* scales;     // (O, G) if PER_GROUP, else (O,)
  static constexpr int kValueBytes = 1;
  static constexpr int kStagedScaleBytes = PER_GROUP ? sizeof(float) : 0;
  __host__ __device__ __forceinline__ const char* value_bytes() const {
    return reinterpret_cast<const char*>(values);
  }
  __host__ __device__ __forceinline__ const char* staged_scale_bytes() const {
    return PER_GROUP ? reinterpret_cast<const char*>(scales) : nullptr;
  }
  // row o's scale rounded to the activation type (per row; 1 if PER_GROUP)
  __device__ __forceinline__ float row_scale(int o) const {
    return PER_GROUP ? 1.f : round_to<XT>(__ldg(scales + o));
  }
  struct Row {
    const int8_t* values;    // the staged copy
    const float* scales;     // PER_GROUP: the row's G staged scales
    float scale;             // otherwise: the row's rounded scale
    __device__ __forceinline__ float raw(size_t slot) const {
      return static_cast<float>(values[slot]);
    }
    __device__ __forceinline__ float finish(float s, int g) const {
      return round_to<XT>(s * (PER_GROUP ? round_to<XT>(scales[g]) : scale));
    }
    // the four slots [slot, slot + 4), in groups g[0..3] (one 4-byte load of
    // the values, slot a multiple of 4)
    __device__ __forceinline__ void load4(size_t slot, const int (&g)[4],
                                          float (&w)[4]) const {
      const char4 v = *reinterpret_cast<const char4*>(values + slot);
      const int8_t q[4] = {static_cast<int8_t>(v.x), static_cast<int8_t>(v.y),
                           static_cast<int8_t>(v.z), static_cast<int8_t>(v.w)};
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = finish(static_cast<float>(q[j]), g[j]);
    }
  };
  __device__ __forceinline__ Row row(const void* v, const float* row_scales,
                                     float scale) const {
    return {static_cast<const int8_t*>(v), row_scales, scale};
  }
};

// The summed weight of slot `n` of the group whose ne slots start at `group`,
// before finish().  Without FOLD: the slot's own raw value.  With FOLD: 0 when
// an earlier slot of the group has the same index (that slot carries the sum),
// else this slot's value plus every later slot at its index, rounded to the
// activation type after each add, in slot order.  The group's pairs are
// adjacent, so the search reads L1-resident lines.  `ne` is the slots read: a
// tier view's fold looks only inside its prefix.
template <bool FOLD, typename XT, typename W>
__device__ __forceinline__ float fold_slot(const W& weights, const int32_t* __restrict__ indices,
                                           size_t group, int n, int ne, int idx) {
  float s = weights.raw(group + n);
  if (FOLD) {
    for (int j = 0; j < n; ++j)
      if (indices[group + j] == idx) return 0.f;
    for (int j = n + 1; j < ne; ++j)
      if (indices[group + j] == idx) s = round_to<XT>(s + weights.raw(group + j));
  }
  return s;
}

// One column of the staged x tile: BT activations in their own type, aligned so
// that the column moves with one shared-memory load (up to 16 bytes at a time).
template <typename XT, int BT>
struct alignas(sizeof(XT) * BT < 16 ? sizeof(XT) * BT : 16) XVec {
  XT v[BT];
};

template <typename XT> __device__ __forceinline__ XT zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Ask for the 128-byte lines of [base, base + bytes) to be brought into L2,
// one line per lane and round.
__device__ __forceinline__ void prefetch_l2(const char* base, size_t bytes, int lane) {
  for (size_t off = static_cast<size_t>(lane) * 128; off < bytes; off += 32 * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + off));
}

constexpr int kPrefetchRows = 2;   // rows per warp prefetched ahead of the staging

template <typename XT, int BT, bool FOLD, typename W>
__global__ void __launch_bounds__(kThreads)
xwt_kernel(const XT* __restrict__ x, W weights, const int32_t* __restrict__ indices,
           float* __restrict__ y, int bx, int k, int o_total, int g_total, int m, int ne,
           int pitch, int rows_per_block, int chunk_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  XVec<XT, BT>* xs = reinterpret_cast<XVec<XT, BT>*>(smem_raw);   // [chunk_k] columns

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * BT;
  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(row0 + rows_per_block, o_total);
  const int slots_per_row = g_total * pitch;   // stored; ne of every pitch are read
  const int step_g = 32 / ne;
  const int step_n = 32 % ne;

  for (int g0 = 0; g0 < g_total; g0 += chunk_groups) {
    const int g1 = min(g0 + chunk_groups, g_total);
    const int chunk_k = (g1 - g0) * m;
    const int k0 = g0 * m;

    if (g0 == 0) {
      // The packed pairs of this warp's first rows come from device memory and
      // do not depend on x: start them towards L2 while x is being staged.
      int r = 0;
      for (int o = row0 + warp; o < row_end && r < kPrefetchRows; o += kWarps, ++r) {
        const size_t row_base = static_cast<size_t>(o) * slots_per_row;
        prefetch_l2(weights.value_bytes() + row_base * W::kValueBytes,
                    static_cast<size_t>(slots_per_row) * W::kValueBytes, lane);
        prefetch_l2(reinterpret_cast<const char*>(indices + row_base),
                    static_cast<size_t>(slots_per_row) * sizeof(int32_t), lane);
      }
    }

    __syncthreads();   // the previous chunk's readers are done
    // Stage x[b0:b0+BT, k0:k0+chunk_k] transposed: a thread reads one column
    // of the tile (BT coalesced loads, rows past bx read as 0) and writes it
    // with one vector store.
#pragma unroll 4
    for (int c = threadIdx.x; c < chunk_k; c += kThreads) {
      XVec<XT, BT> col;
#pragma unroll
      for (int b = 0; b < BT; ++b)
        col.v[b] = (b0 + b < bx) ? x[static_cast<size_t>(b0 + b) * k + k0 + c]
                                 : zero_of<XT>();
      xs[c] = col;
    }
    __syncthreads();

    const int s0 = g0 * ne;
    const int s1 = g1 * ne;
    for (int o = row0 + warp; o < row_end; o += kWarps) {
      const size_t row_base = static_cast<size_t>(o) * slots_per_row;
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;

      // A lane's pairs are 32 apart in the read slots: its (group, slot)
      // position advances by a fixed step with a carry, so the division is
      // paid once per row; the slot is stored at g * pitch + n.
      int g = (s0 + lane) / ne;
      int n = (s0 + lane) - g * ne;
#pragma unroll 4
      for (int s = s0 + lane; s < s1; s += 32) {
        const size_t at = row_base + static_cast<size_t>(g) * pitch + n;
        const int idx = indices[at];
        const int col = (g - g0) * m + idx;
        // the main path (no duplicates) keeps its one load per pair as it
        // was before the fold existed: measured 9 % faster than routing it
        // through fold_slot<false>
        float w;
        if constexpr (FOLD)
          w = weights.finish(fold_slot<true, XT>(weights, indices, at - n, n, ne, idx),
                             weights.xwt_scale(o, g));
        else
          w = weights.load(at, o, g);
        const XVec<XT, BT> xv = xs[col];
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = fmaf(w, to_float<XT>(xv.v[b]), acc[b]);
        g += step_g;
        n += step_n;
        if (n >= ne) { n -= ne; ++g; }
      }

#pragma unroll
      for (int b = 0; b < BT; ++b) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          if (b0 + b < bx) {
            float* dst = y + static_cast<size_t>(b0 + b) * o_total + o;
            *dst = (g0 == 0 ? 0.f : *dst) + acc[b];
          }
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// The dynamic shared memory of the last kernel this library launched, set by
// every launcher just before its launch (host bookkeeping, one copy for the
// whole library): the autotuner holds its shared-memory model against it.
inline int last_launch_smem = 0;

// A device attribute, asked for once per device and kept.  (Internal linkage:
// the cached values belong to this library alone.)
template <cudaDeviceAttr ATTR>
static int device_attr(int dev) {
  static int cached[kMaxDevices] = {0};
  if (cached[dev] == 0) {
    int value = 0;
    if (cudaDeviceGetAttribute(&value, ATTR, dev) != cudaSuccess) return 0;
    cached[dev] = value;
  }
  return cached[dev];
}

// Output rows per block when the caller leaves the choice open: enough blocks
// to keep up to four resident on every SM (fewer where the staged x tile
// leaves room for fewer), in multiples of the block's warps.  The whole launch
// is one pass over a few megabytes, so many small blocks, each with its loads
// in flight at once, hide more latency than few large ones.
inline int auto_rows_per_block(int o, int smem, int smem_limit, int sm_count) {
  int per_sm = smem > 0 ? smem_limit / smem : 4;
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  const int blocks = sm_count * per_sm;
  const int rows = (o + blocks - 1) / blocks;
  return ((rows + kWarps - 1) / kWarps) * kWarps;
}

template <typename XT, int BT, bool FOLD, typename W>
static int launch_bt(const XT* x, W weights, const int32_t* indices, float* y, int bx, int k,
              int o, int g, int m, int ne, int pitch, int rows_per_block,
              cudaStream_t stream) {
  auto kernel = xwt_kernel<XT, BT, FOLD, W>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrBadShape;
  const int smem_limit = device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(dev);
  const size_t group_bytes = static_cast<size_t>(m) * BT * sizeof(XT);
  if (smem_limit <= 0 || group_bytes > static_cast<size_t>(smem_limit)) return kErrGroupTooWide;
  int chunk_groups = static_cast<int>(static_cast<size_t>(smem_limit) / group_bytes);
  if (chunk_groups > g) chunk_groups = g;
  const int smem = static_cast<int>(chunk_groups * group_bytes);
  // Opt in to more than 48 KB of dynamic shared memory once per size reached
  // (per instantiation and device), not on every launch.
  static int opted_in[kMaxDevices] = {0};
  if (smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = smem;
  }
  if (rows_per_block <= 0) {
    const int sms = device_attr<cudaDevAttrMultiProcessorCount>(dev);
    if (sms <= 0) return kErrBadShape;
    rows_per_block = auto_rows_per_block(o, smem, smem_limit, sms);
  }
  dim3 grid((o + rows_per_block - 1) / rows_per_block, (bx + BT - 1) / BT);
  if (grid.y > 65535u) return kErrBadShape;   // more activation tiles than a grid holds
  last_launch_smem = smem;
  kernel<<<grid, kThreads, smem, stream>>>(x, weights, indices, y, bx, k, o, g, m, ne, pitch,
                                           rows_per_block, chunk_groups);
  return static_cast<int>(cudaGetLastError());
}

// Pick the activation-row tile: the smallest of 1, 2, 4, 8 that covers bx
// (8 for anything larger; the grid's second dimension walks the tiles).
template <typename XT, bool FOLD, typename W>
int launch_fold(const XT* x, W weights, const int32_t* indices, float* y, int bx, int k,
                int o, int g, int m, int ne, int pitch, int rows_per_block,
                cudaStream_t stream) {
  if (bx <= 1) return launch_bt<XT, 1, FOLD, W>(x, weights, indices, y, bx, k, o, g, m, ne, pitch, rows_per_block, stream);
  if (bx <= 2) return launch_bt<XT, 2, FOLD, W>(x, weights, indices, y, bx, k, o, g, m, ne, pitch, rows_per_block, stream);
  if (bx <= 4) return launch_bt<XT, 4, FOLD, W>(x, weights, indices, y, bx, k, o, g, m, ne, pitch, rows_per_block, stream);
  return launch_bt<XT, 8, FOLD, W>(x, weights, indices, y, bx, k, o, g, m, ne, pitch, rows_per_block, stream);
}

// `duplicates` == 0 promises that no group holds two non-zero slots at one
// index, and selects the instantiations without the fold (the main path).  A
// launch that may hold duplicates takes the folding body at the widest tile
// only, which masks the rows past bx: one instantiation per weight type
// instead of four keeps the build short.
template <typename XT, typename W>
int launch_xt(const XT* x, W weights, const int32_t* indices, float* y, int bx, int k,
              int o, int g, int m, int ne, int pitch, int duplicates, int rows_per_block,
              cudaStream_t stream) {
  if (duplicates)
    return launch_bt<XT, 8, true, W>(x, weights, indices, y, bx, k, o, g, m, ne, pitch, rows_per_block, stream);
  return launch_fold<XT, false, W>(x, weights, indices, y, bx, k, o, g, m, ne, pitch, rows_per_block, stream);
}

// Make `device` current for the launch and restore the caller's afterwards.
struct DeviceGuard {
  int prev = -1;
  bool switched = false;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      switched = (err == cudaSuccess);
    }
  }
  ~DeviceGuard() { if (switched) cudaSetDevice(prev); }
};

// `ne` slots read of the `pitch` stored per group (a tier view: ne < pitch).
inline bool shapes_ok(int bx, int k, int o, int g, int m, int ne, int pitch,
                      int rows_per_block) {
  return bx >= 1 && o >= 1 && g >= 1 && m >= 1 && ne >= 1 && ne <= pitch && pitch <= m &&
         static_cast<long long>(g) * m == k && rows_per_block >= 0;
}

}  // namespace demm
