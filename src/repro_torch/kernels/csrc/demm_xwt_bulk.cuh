// The bulk-copy row-tile body of y = x @ W_sparse^T at serving batch
// (Bx <= 8), over the row-packed {values, indices} stream (O, G, Ne): the
// arithmetic of demm_xwt_common.cuh, unchanged -- every value rounded to the
// activation type, duplicate slots summed in that type in slot order
// (fold_slot), products and sums in float32, y in float32, a padded slot
// adding exactly 0.
//
// What it is built on: a tile of consecutive output rows is one contiguous
// span of values and one of indices (and, for K3's per-group scales, one of
// scales), so the whole tile can be requested by 1-D bulk copies (TMA) at
// entry, and x can be staged once per CTA instead of once per small thread
// block.
//
//   * Tile.  A CTA owns `rows` consecutive output rows, sized so that each
//     SM holds about one CTA.  The tile goes in row chunks of `chunk_rows`
//     (by default one: the whole tile); one thread requests every chunk that
//     fits shared memory at entry (two bulk copies each, three with staged
//     scales; one mbarrier per chunk), and a tile larger than shared memory
//     goes through a ring of at least two chunks, compute starting as soon
//     as the first lands.
//   * x.  Meanwhile every thread loads x with 16-byte loads, each CTA
//     starting at its own place, and writes it transposed to [column][BT]
//     in the activation type, so one pair's BT activations cost one shared
//     load.  The columns are swizzled (bulk_swizzle): unswizzled, the
//     staging stores met in one bank pair and cost up to 2 us a launch.
//     (Sharing x across a cluster of 2 or 4 CTAs along O -- pushed through
//     distributed shared memory, or multicast by bulk copies and transposed
//     in each CTA -- was slower at every full-width stablelm_3b shape, and
//     was taken out.)
//   * Compute.  512 threads; 16 lanes (the slot lanes, a half warp; 32
//     rows a pass) own one row of a chunk at a time -- for K3, 8 lanes (64
//     rows a pass) at chunks of more than 32 rows (bulk_auto_lanes: 53 rows
//     at 6912 x 2560 go in one pass, not two).  They stride over the row's
//     G*Ne pairs in shared memory, four adjacent pairs per step with one
//     vector load of indices and one of values, keep BT float32 sums in
//     registers, and a shuffle tree adds the lanes in a fixed order.  One
//     lane writes each y once: no atomics, deterministic.  (A first version
//     gave each of 8 warps one row at a time, one pair per lane per step:
//     its compute, latency-bound at one CTA per SM, ran on well after the
//     last bytes had landed.)
//
// K1 and K3 both run it.  The weight policy W is a template parameter
// (FloatWeights for K1; Int8BulkWeights for K3, its scale unit fixed at
// compile time): per-group scales come into shared memory with the chunk's
// pairs, a third bulk copy on the same barrier, and a per-row scale is read
// once per row pass into a register, so the inner loop reads no scale from
// device memory.
//
// Bound on an H100: the packed bytes over device-memory bandwidth; this
// body's job is to have all of a CTA's bytes in flight at once and to read
// x from L2 once per CTA rather than once per small block.
//
// The sizes are __host__ __device__ helpers a CPU build of the header can
// check; the copies and barriers are not.

#pragma once

#include "demm_xwt_common.cuh"
#include "hopper_async.cuh"

namespace demm {

constexpr int kBulkThreads = 512;
constexpr int kBulkUnit = 4;           // adjacent pairs a lane reads at once
constexpr int kBulkMaxBt = 8;          // widest activation tile (Bx <= 8)
constexpr int kBulkMaxStages = 16;     // mbarriers: chunks in flight at once
constexpr int kBulkHeadBytes = 128;    // the mbarriers, before the x tile

struct BulkGeom {
  int bx, k, o, g, m, ne;
  int rows;          // output rows per CTA
  int chunk_rows;    // rows per chunk (one mbarrier each; bulk_plan)
  int stages;        // chunks in flight at once (all of them, or a ring; bulk_plan)
};

// Slot lanes per row where the launcher leaves the choice open (K3): 8 when
// a chunk holds more than 32 rows -- one pass of the CTA's threads over up to
// 64 rows in place of two over 32 (each pass waits on its slowest row and
// ends in a shuffle tree) -- else 16, a half warp.  At least the widest
// tile, 8: lane b writes y's row b.
__host__ __device__ inline int bulk_auto_lanes(int chunk_rows) {
  return chunk_rows > kBulkThreads / 16 ? 8 : 16;
}

// Column c of the transposed x tile lives at xs[bulk_swizzle(c)]: bits 4-7
// of c XORed into bits 0-3.  The staging threads each write 8 (4) columns
// 8 (4) apart from their neighbours' -- without the swizzle, 16 lanes of a
// warp would store into one bank pair; with it, 16 consecutive 8-column
// vectors land on 16 different bank pairs.  The compute's reads are random
// either way.  A bijection on every 16-column block.
__host__ __device__ __forceinline__ int bulk_swizzle(int c) { return c ^ ((c >> 4) & 15); }

// Bytes of the transposed x tile: K rounded up to 16 columns (the swizzle's
// blocks).
template <typename XT, int BT>
__host__ __device__ inline size_t bulk_x_bytes(int k) {
  return static_cast<size_t>((k + 15) & ~15) * sizeof(XVec<XT, BT>);
}

// Bytes of one output row in a stage: its pairs (values, then indices) and
// its staged scales (K3 per group: G floats), each a 16-byte multiple (the
// launcher checks).
template <typename W>
__host__ __device__ inline size_t bulk_row_bytes(int g, int ne) {
  return static_cast<size_t>(g) * ne * (W::kValueBytes + sizeof(int32_t)) +
         static_cast<size_t>(g) * W::kStagedScaleBytes;
}

// Stage plan.  `chunks` row chunks per tile as asked (0: the whole tile in
// one chunk, which `chip_smoke.py --sweep` found fastest at every full-width
// stablelm_3b shape: the chunks land nearly together, and each costs a pass
// of the CTA's row lanes however few rows it holds), at most kBulkMaxStages; every
// chunk in flight at once when they all fit, else a ring of as many chunks
// as fit, at least two, with fewer rows per chunk where two do not fit.
// Fills chunk_rows / stages and the dynamic shared memory; false when not
// even two one-row chunks fit beside the x tile (kernels/demm_xwT.xwt_body
// states the same rule).
inline bool bulk_plan(BulkGeom* geo, int chunks, size_t x_bytes, size_t row_bytes,
                      int smem_limit, int* smem) {
  const size_t fixed = kBulkHeadBytes + x_bytes;
  if (smem_limit <= 0 || fixed + 2 * row_bytes > static_cast<size_t>(smem_limit)) return false;
  const size_t avail = static_cast<size_t>(smem_limit) - fixed;
  int rows_per = chunks > 0 ? (geo->rows + chunks - 1) / chunks : geo->rows;
  if (rows_per > geo->rows) rows_per = geo->rows;
  if (rows_per * kBulkMaxStages < geo->rows)
    rows_per = (geo->rows + kBulkMaxStages - 1) / kBulkMaxStages;
  int nchunks = (geo->rows + rows_per - 1) / rows_per;
  int stages = nchunks;
  if (static_cast<size_t>(nchunks) * rows_per * row_bytes > avail) {   // a ring
    if (2 * rows_per * row_bytes > avail) rows_per = static_cast<int>(avail / (2 * row_bytes));
    nchunks = (geo->rows + rows_per - 1) / rows_per;
    stages = static_cast<int>(avail / (rows_per * row_bytes));
    if (stages > kBulkMaxStages) stages = kBulkMaxStages;
    if (stages > nchunks) stages = nchunks;
  }
  geo->chunk_rows = rows_per;
  geo->stages = stages;
  *smem = static_cast<int>(fixed + static_cast<size_t>(stages) * rows_per * row_bytes);
  return true;
}

// One CTA per SM (its shared memory allows no more): telling ptxas so lets
// it use up to 128 registers; left to guess, it capped the summing
// instantiations at 40-64 and spilled.
template <typename XT, int BT, bool FOLD, int LANES, typename W>
__global__ void __launch_bounds__(kBulkThreads, 1)
xwt_bulk_kernel(const XT* __restrict__ x, W weights, const int32_t* __restrict__ indices,
                float* __restrict__ y, BulkGeom geo) {
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);                   // [stages]
  XVec<XT, BT>* xs = reinterpret_cast<XVec<XT, BT>*>(smem_raw + kBulkHeadBytes);  // [k]
  unsigned char* stage0 = smem_raw + kBulkHeadBytes + bulk_x_bytes<XT, BT>(geo.k);

  const int pairs = geo.g * geo.ne;                         // per output row
  const size_t sc_row = static_cast<size_t>(geo.g) * W::kStagedScaleBytes;
  const size_t vals_b = static_cast<size_t>(geo.chunk_rows) * pairs * W::kValueBytes;
  const size_t scs_at = vals_b + static_cast<size_t>(geo.chunk_rows) * pairs * sizeof(int32_t);
  const size_t stage_b = scs_at + geo.chunk_rows * sc_row;
  const int row0 = blockIdx.x * geo.rows;
  const int row_end = min(row0 + geo.rows, geo.o);
  const int nchunks = (row_end - row0 + geo.chunk_rows - 1) / geo.chunk_rows;

  // One thread initialises the barriers and requests the chunks; the others
  // start on x at once (nobody else touches a barrier before the
  // __syncthreads that ends the staging).
  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.stages; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
  }

  // One thread: request chunk c of the tile's rows into stage c % stages.
  auto issue = [&](int c) {
    const int r0 = row0 + c * geo.chunk_rows;
    const int n = min(geo.chunk_rows, row_end - r0);
    const int s = c % geo.stages;
    unsigned char* at = stage0 + s * stage_b;
    const size_t first = static_cast<size_t>(r0) * pairs;
    const uint32_t vb = static_cast<uint32_t>(static_cast<size_t>(n) * pairs * W::kValueBytes);
    const uint32_t ib = static_cast<uint32_t>(static_cast<size_t>(n) * pairs * sizeof(int32_t));
    const uint32_t sb = static_cast<uint32_t>(n * sc_row);
    mbar_arrive_expect_tx(&bars[s], vb + ib + sb);
    bulk_g2s(at, weights.value_bytes() + first * W::kValueBytes, vb, &bars[s]);
    bulk_g2s(at + vals_b, indices + first, ib, &bars[s]);
    if constexpr (W::kStagedScaleBytes > 0)
      bulk_g2s(at + scs_at, weights.staged_scale_bytes() + r0 * sc_row, sb, &bars[s]);
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < nchunks && c < geo.stages; ++c) issue(c);

  // Every thread: x's 16-byte column vectors, one of every row at a time,
  // written transposed (swizzled); rows past bx are 0.  Each CTA starts at
  // its own place, so that the CTAs do not all ask L2 for the same lines at
  // once.
  constexpr int kVec = 16 / sizeof(XT);
  const int nvec = geo.k / kVec;
  const int rot = static_cast<int>((static_cast<long long>(blockIdx.x) * 997) % nvec);
  for (int i = threadIdx.x; i < nvec; i += kBulkThreads) {
    const int v = i + rot < nvec ? i + rot : i + rot - nvec;
    uint4 raw[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b)
      raw[b] = b < geo.bx ? *reinterpret_cast<const uint4*>(
                                x + static_cast<size_t>(b) * geo.k + static_cast<size_t>(v) * kVec)
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      XVec<XT, BT> col;
#pragma unroll
      for (int b = 0; b < BT; ++b) col.v[b] = reinterpret_cast<const XT*>(&raw[b])[e];
      xs[bulk_swizzle(v * kVec + e)] = col;
    }
  }
  __syncthreads();   // x is in place, the barriers initialised

  // A row of a chunk belongs to LANES slot lanes (8 or 16); each lane reads
  // kBulkUnit adjacent pairs with one vector load of indices and one of
  // values, then the next unit `stride` pairs on.  A lane's (group, slot)
  // position advances by a fixed step with a carry.
  constexpr int rows_per_pass = kBulkThreads / LANES;
  constexpr int stride = LANES * kBulkUnit;
  const int rlane = threadIdx.x / LANES;
  const int sl = threadIdx.x % LANES;
  const int p0 = kBulkUnit * sl;
  const int step_g = stride / geo.ne;
  const int step_n = stride % geo.ne;
  const int lane_g = p0 / geo.ne;
  const int lane_n = p0 - lane_g * geo.ne;
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % geo.stages;
    const int r0 = row0 + c * geo.chunk_rows;
    const int n = min(geo.chunk_rows, row_end - r0);
    // this lane's row scale in a pass (K3 per row; a constant 1 otherwise),
    // the first one read while the chunk is still in flight
    auto pass_scale = [&](int pass) { return weights.row_scale(r0 + min(pass + rlane, n - 1)); };
    float scale = pass_scale(0);
    mbar_wait(&bars[s], (c / geo.stages) & 1);
    const unsigned char* at = stage0 + s * stage_b;
    const int32_t* idxs = reinterpret_cast<const int32_t*>(at + vals_b);
    const float* scs = reinterpret_cast<const float*>(at + scs_at);
    // passes over the chunk's rows, the same count for every lane of a warp
    // (the shuffles below need all 32)
    for (int pass = 0; pass < n; pass += rows_per_pass) {
      const int rl = pass + rlane;
      const bool live = rl < n;
      const int o = r0 + rl;
      const size_t base = static_cast<size_t>(live ? rl : 0) * pairs;
      const typename W::Row ws = weights.row(at, scs + (live ? rl : 0) * geo.g, scale);
      if (pass + rows_per_pass < n) scale = pass_scale(pass + rows_per_pass);
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      int g = lane_g;
      int nn = lane_n;
      // (The summing search is not unrolled: at the widest tile it spills.)
#pragma unroll(FOLD ? 1 : 2)
      for (int p = live ? p0 : pairs; p < pairs; p += stride) {
        const int4 iv = *reinterpret_cast<const int4*>(idxs + base + p);
        const int idx[kBulkUnit] = {iv.x, iv.y, iv.z, iv.w};
        int gj[kBulkUnit], nj[kBulkUnit];
        gj[0] = g;
        nj[0] = nn;
#pragma unroll
        for (int j = 1; j < kBulkUnit; ++j) {
          const bool carry = nj[j - 1] + 1 == geo.ne;
          nj[j] = carry ? 0 : nj[j - 1] + 1;
          gj[j] = carry ? gj[j - 1] + 1 : gj[j - 1];
        }
        float w[kBulkUnit];
        if constexpr (FOLD) {
#pragma unroll
          for (int j = 0; j < kBulkUnit; ++j)
            w[j] = ws.finish(
                fold_slot<true, XT>(ws, idxs, base + p + j - nj[j], nj[j], geo.ne, idx[j]),
                gj[j]);
        } else {
          ws.load4(base + p, gj, w);
        }
#pragma unroll
        for (int j = 0; j < kBulkUnit; ++j) {
          const XVec<XT, BT> xv = xs[bulk_swizzle(gj[j] * geo.m + idx[j])];
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] = fmaf(w[j], to_float<XT>(xv.v[b]), acc[b]);
        }
        g += step_g;
        nn += step_n;
        if (nn >= geo.ne) { nn -= geo.ne; ++g; }
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) {
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
      }
      if (live) {
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (sl == b && b < geo.bx) y[static_cast<size_t>(b) * geo.o + o] = acc[b];
      }
    }
    if (c + geo.stages < nchunks) {   // a ring: stage s is refilled once every row is done
      __syncthreads();
      if (threadIdx.x == 0) issue(c + geo.stages);
    }
  }
}

// Rows per CTA when the caller leaves the choice open: about one CTA per SM.
inline int bulk_auto_rows(int o, int sm_count) {
  const int rows = (o + sm_count - 1) / sm_count;
  return rows < 1 ? 1 : rows;
}

// Start the kernel, opting in to its shared memory once per size reached.
template <typename XT, int BT, bool FOLD, int LANES, typename W>
static int start_bulk(const XT* x, W weights, const int32_t* indices, float* y,
                      const BulkGeom& geo, int smem, int dev, cudaStream_t stream) {
  auto kernel = xwt_bulk_kernel<XT, BT, FOLD, LANES, W>;
  static int opted_in[kMaxDevices] = {0};
  if (smem > opted_in[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = smem;
  }
  const unsigned blocks = static_cast<unsigned>((geo.o + geo.rows - 1) / geo.rows);
  kernel<<<blocks, kBulkThreads, smem, stream>>>(x, weights, indices, y, geo);
  return static_cast<int>(cudaGetLastError());
}

// LANES as launch_bulk's.
template <typename XT, int BT, bool FOLD, int LANES, typename W>
static int launch_bulk_bt(const XT* x, W weights, const int32_t* indices, float* y,
                          BulkGeom geo, int chunks, int lanes, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrBadShape;
  const int smem_limit = device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(dev);
  const int sms = device_attr<cudaDevAttrMultiProcessorCount>(dev);
  if (smem_limit <= 0 || sms <= 0) return kErrBadShape;
  if (geo.rows <= 0) geo.rows = bulk_auto_rows(geo.o, sms);
  if (geo.rows > geo.o) geo.rows = geo.o;
  int smem = 0;
  if (!bulk_plan(&geo, chunks, bulk_x_bytes<XT, BT>(geo.k), bulk_row_bytes<W>(geo.g, geo.ne),
                 smem_limit, &smem))
    return kErrGroupTooWide;
  if constexpr (LANES == 0) {
    if ((lanes ? lanes : bulk_auto_lanes(geo.chunk_rows)) == 8)
      return start_bulk<XT, BT, FOLD, 8, W>(x, weights, indices, y, geo, smem, dev, stream);
    return start_bulk<XT, BT, FOLD, 16, W>(x, weights, indices, y, geo, smem, dev, stream);
  } else {
    return start_bulk<XT, BT, FOLD, LANES, W>(x, weights, indices, y, geo, smem, dev, stream);
  }
}

// Whether the bulk body can take these arguments: Bx <= 8; x's rows (K
// activations) a multiple of 16 bytes and x 16-byte aligned; a row's values,
// its indices and its staged scales each a multiple of 16 bytes (G*Ne*value
// bytes, G*Ne*4, G*4 for K3's per-group scales) and those arrays 16-byte
// aligned.  The choice of body is made by the caller
// (kernels/demm_xwT.xwt_body states the rule); this check only asserts it,
// refusing what the copies cannot take.  (Shared memory is checked by the
// stage plan.)
template <typename XT, typename W>
inline bool bulk_takes(const BulkGeom& g, const void* x, const W& weights,
                       const int32_t* indices) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const size_t pairs = static_cast<size_t>(g.g) * g.ne;
  return g.bx >= 1 && g.bx <= kBulkMaxBt &&
         (static_cast<size_t>(g.k) * sizeof(XT)) % 16 == 0 &&
         (pairs * W::kValueBytes) % 16 == 0 && (pairs * sizeof(int32_t)) % 16 == 0 &&
         (static_cast<size_t>(g.g) * W::kStagedScaleBytes) % 16 == 0 &&
         aligned(x) && aligned(weights.value_bytes()) && aligned(indices) &&
         aligned(weights.staged_scale_bytes());
}

// Pick the activation tile (the smallest of 1, 2, 4, 8 that covers bx) and
// the summing instantiation (at the widest tile only, as launch_xt).  LANES:
// the slot lanes per row fixed at compile time (K1: 16), or 0 to choose 8
// or 16 at each launch -- `lanes` if given, else bulk_auto_lanes (K3).
template <typename XT, int LANES, typename W>
int launch_bulk(const XT* x, W weights, const int32_t* indices, float* y, const BulkGeom& geo,
                int duplicates, int chunks, int lanes, cudaStream_t stream) {
  if (!bulk_takes<XT, W>(geo, x, weights, indices) || chunks < 0 ||
      !(lanes == 0 || lanes == LANES || (LANES == 0 && (lanes == 8 || lanes == 16))))
    return kErrBadShape;
  if (duplicates)
    return launch_bulk_bt<XT, 8, true, LANES, W>(x, weights, indices, y, geo, chunks, lanes,
                                                 stream);
  if (geo.bx <= 1)
    return launch_bulk_bt<XT, 1, false, LANES, W>(x, weights, indices, y, geo, chunks, lanes,
                                                  stream);
  if (geo.bx <= 2)
    return launch_bulk_bt<XT, 2, false, LANES, W>(x, weights, indices, y, geo, chunks, lanes,
                                                  stream);
  if (geo.bx <= 4)
    return launch_bulk_bt<XT, 4, false, LANES, W>(x, weights, indices, y, geo, chunks, lanes,
                                                  stream);
  return launch_bulk_bt<XT, 8, false, LANES, W>(x, weights, indices, y, geo, chunks, lanes,
                                                stream);
}

}  // namespace demm
