// Shared body of the two-level block spmm kernels: C = A_sparse @ B.
//
// What is computed.  A (R, K) is packed in row blocks of block_r rows.  Row
// block i lists a_max *list slots*; list slot j names one M-group of K,
// group(i, j) = active_groups[i, j] (level 1, the address stream), and holds
// for every row of the block ne {value, index} pairs inside that group
// (level 2).  With S(i, j, r) the group's scatter row -- the packed values
// rounded to B's type, slots that share an index summed in that type in slot
// order, times the scale rounded to B's type for int8 values --
//
//   C[i*block_r + r, c] = sum_j sum_t S(i, j, r)[t] * B[group(i, j)*M + t, c]
//
// with every product and the sum over list slots in float32 (a group listed
// twice adds after its product), and C in float32.  Padded list slots (group
// 0, all-zero values) add exactly 0.  The same body runs
//   * K2 / K4, the block layout (RB, A_max, block_r, Ne), and
//   * K5, the row-packed layout (R, G, Ne) of C = A_sparse @ B, as one row
//     block with the identity address stream (group(0, j) = j, a_max = G);
// the layouts differ only in the strides of a (row block, list slot, row)
// triple, which the launcher passes.  Nothing is repacked.
//
// Work split.  A thread block owns `rows` consecutive rows of one row block
// and a tile of BT columns of B; its 256 threads are rows x slot_lanes.  For
// each chunk of list slots it first stages, in shared memory, the M rows of B
// that each slot's group names -- the decoupled read port: a group that is not
// listed is never read -- transposed to [row of B][BT] in B's type.  Then
// each thread walks the list slots j = slot_lane, slot_lane + slot_lanes, ...
// of its own row: the ne pairs of one (row, slot) are adjacent in memory, the
// lanes of a warp take neighbouring rows of one slot (block layout) or
// neighbouring slots of one row (row-packed layout), whichever is adjacent,
// so a warp's loads are coalesced.  BT float32 sums stay in registers; at the
// end the slot lanes of a row add up through shared memory in a fixed order.
// `block_r` is packing geometry, not launch geometry: a 128-row block is
// split over several thread blocks that read the same active_groups row, so a
// 2560-row weight (20 row blocks) still fills the card.
//
// Bound on this card: at serving batch sizes the work is one pass over the
// packed bytes (values + indices + the address stream), so device-memory
// bandwidth is the limit, as for the xwT kernels.

#pragma once

#include "demm_xwt_common.cuh"

namespace demm {

struct BlockGeom {
  int r;             // rows of A (and of C)
  int cd;            // columns of B (and of C)
  int groups;        // G = K / M
  int a_max;         // list slots per row block
  int block_r;       // rows per row block
  int m, ne;
  long long s_rb, s_j, s_row;   // element strides of values/indices
  long long s_bk, s_bc;         // element strides of B
  long long s_cr, s_cc;         // element strides of C
  int rows;          // rows per thread block
  int slot_lanes;    // kThreads / rows
  int parts;         // thread blocks per row block: ceil(block_r / rows)
  int chunk_slots;   // list slots staged per pass
  int rows_fastest;  // lane order: 1 block layout, 0 row-packed layout
};

// Bytes of the staged B tile, rounded up so that the reduction scratch after
// it is aligned.
template <typename XT, int BT>
__host__ __device__ __forceinline__ size_t block_tile_bytes(int chunk_slots, int m) {
  const size_t bytes = static_cast<size_t>(chunk_slots) * m * sizeof(XVec<XT, BT>);
  return (bytes + 15) & ~static_cast<size_t>(15);
}

template <typename XT, int BT, bool FOLD, typename W>
__global__ void __launch_bounds__(kThreads)
block_spmm_kernel(const int32_t* __restrict__ active_groups, W weights,
                  const int32_t* __restrict__ indices, const XT* __restrict__ b,
                  float* __restrict__ c, BlockGeom geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  XVec<XT, BT>* xs = reinterpret_cast<XVec<XT, BT>*>(smem_raw);   // [chunk_slots * m]
  float* red = reinterpret_cast<float*>(
      smem_raw + block_tile_bytes<XT, BT>(geo.chunk_slots, geo.m));  // [slot_lanes][rows][BT]

  const int rbi = blockIdx.x / geo.parts;
  const int rr0 = (blockIdx.x - rbi * geo.parts) * geo.rows;
  const int c0 = blockIdx.y * BT;
  int row_lane, slot_lane;
  if (geo.rows_fastest) {
    row_lane = threadIdx.x % geo.rows;
    slot_lane = threadIdx.x / geo.rows;
  } else {
    slot_lane = threadIdx.x % geo.slot_lanes;
    row_lane = threadIdx.x / geo.slot_lanes;
  }
  const int rr = rr0 + row_lane;
  const bool live = rr < geo.block_r;
  // null: the identity address stream (row-packed layout, list slot j = group j)
  const int32_t* ag_row =
      active_groups ? active_groups + static_cast<size_t>(rbi) * geo.a_max : nullptr;
  // B stored (K, Cd) row-major: a thread's BT columns move as one vector
  const bool vec_cols = geo.s_bc == 1;

  float acc[BT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) acc[bb] = 0.f;

  for (int j0 = 0; j0 < geo.a_max; j0 += geo.chunk_slots) {
    const int j1 = min(j0 + geo.chunk_slots, geo.a_max);
    const int chunk_k = (j1 - j0) * geo.m;
    __syncthreads();   // the previous chunk's readers are done
    // The decoupled read port: list slot j stages the M rows of B of the group
    // it names.  A thread takes one row of B and writes its BT columns with
    // one vector store; columns past cd and ids outside [0, G) read as 0.
    for (int t = threadIdx.x; t < chunk_k; t += kThreads) {
      const int jl = t / geo.m;
      const int row = t - jl * geo.m;
      const int gid = ag_row ? ag_row[j0 + jl] : j0 + jl;
      XVec<XT, BT> v;
      if (gid >= 0 && gid < geo.groups) {
        const XT* src = b + (static_cast<long long>(gid) * geo.m + row) * geo.s_bk +
                        static_cast<long long>(c0) * geo.s_bc;
        if (vec_cols && c0 + BT <= geo.cd &&
            reinterpret_cast<uintptr_t>(src) % alignof(XVec<XT, BT>) == 0) {
          v = *reinterpret_cast<const XVec<XT, BT>*>(src);   // B's row is contiguous
        } else {
#pragma unroll
          for (int bb = 0; bb < BT; ++bb)
            v.v[bb] = (c0 + bb < geo.cd) ? src[bb * geo.s_bc] : zero_of<XT>();
        }
      } else {
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) v.v[bb] = zero_of<XT>();
      }
      xs[t] = v;
    }
    __syncthreads();

    if (live) {
      for (int j = j0 + slot_lane; j < j1; j += geo.slot_lanes) {
        const size_t base = static_cast<size_t>(rbi) * geo.s_rb +
                            static_cast<size_t>(j) * geo.s_j +
                            static_cast<size_t>(rr) * geo.s_row;
        const size_t scale_slot =
            (static_cast<size_t>(rbi) * geo.a_max + j) * geo.block_r + rr;
        const XVec<XT, BT>* xj = xs + static_cast<size_t>(j - j0) * geo.m;
        for (int n = 0; n < geo.ne; ++n) {
          const int idx = indices[base + n];
          const float w = weights.finish(
              fold_slot<FOLD, XT>(weights, indices, base, n, geo.ne, idx), scale_slot);
          const XVec<XT, BT> xv = xj[idx];
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) acc[bb] = fmaf(w, to_float<XT>(xv.v[bb]), acc[bb]);
        }
      }
    }
  }

  // Add up the slot lanes of each row in a fixed order, then write C.
  float* mine = red + (static_cast<size_t>(slot_lane) * geo.rows + row_lane) * BT;
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) mine[bb] = acc[bb];
  __syncthreads();
  for (int t = threadIdx.x; t < geo.rows * BT; t += kThreads) {
    const int bb = t / geo.rows;
    const int rl = t - bb * geo.rows;
    const int r_in = rr0 + rl;
    if (r_in >= geo.block_r || c0 + bb >= geo.cd) continue;
    float s = 0.f;
    for (int sl = 0; sl < geo.slot_lanes; ++sl)
      s += red[(static_cast<size_t>(sl) * geo.rows + rl) * BT + bb];
    c[(static_cast<long long>(rbi) * geo.block_r + r_in) * geo.s_cr +
      static_cast<long long>(c0 + bb) * geo.s_cc] = s;
  }
}

inline int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Rows per thread block when the caller leaves the choice open: the largest
// of 32, 16, 8 that still gives every SM a thread block, since one launch is a
// single pass over a few megabytes and fewer, fuller blocks stage B fewer
// times (within 2 us of the fastest choice at every full-width stablelm_3b
// shape, Bx = 4, `chip_smoke.py --sweep` on an H100 80GB HBM3 at 700 W).
// With many column tiles of B, 64 rows: every thread block restages its whole
// K x BT slice of B, and more rows share one staging.  Never more rows than
// the row block holds (rounded up to a power of two); in the row-packed
// layout at least as many as leave no slot lane without a group.
inline int auto_block_rows(const BlockGeom& geo, int col_tiles, int sm_count) {
  int rows = 64;
  if (col_tiles < 8) {
    for (rows = 32; rows > 8; rows >>= 1) {
      const long long blocks = static_cast<long long>(geo.r / geo.block_r) *
                               ((geo.block_r + rows - 1) / rows) * col_tiles;
      if (blocks >= sm_count) break;
    }
  }
  const int cap = pow2_ceil(geo.block_r);
  if (rows > cap) rows = cap;
  if (!geo.rows_fastest) {
    const int lanes = pow2_ceil(geo.a_max);
    if (lanes < kThreads / rows) rows = kThreads / lanes;
  }
  return rows;
}

template <typename XT, int BT, bool FOLD, typename W>
static int launch_block_bt(const int32_t* active_groups, W weights, const int32_t* indices,
                           const XT* b, float* c, BlockGeom geo, int rows_per_block,
                           cudaStream_t stream) {
  auto kernel = block_spmm_kernel<XT, BT, FOLD, W>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrBadShape;
  const int smem_limit = device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(dev);
  const size_t red_bytes = static_cast<size_t>(kThreads) * BT * sizeof(float);
  const size_t slot_bytes = static_cast<size_t>(geo.m) * sizeof(XVec<XT, BT>);
  if (smem_limit <= 0 ||
      block_tile_bytes<XT, BT>(1, geo.m) + red_bytes > static_cast<size_t>(smem_limit))
    return kErrGroupTooWide;
  // Stage as many list slots per pass as half the shared memory holds (two
  // thread blocks per SM), at least one.
  size_t budget = static_cast<size_t>(smem_limit) / 2;
  if (budget < block_tile_bytes<XT, BT>(1, geo.m) + red_bytes) budget = smem_limit;
  int chunk = static_cast<int>((budget - red_bytes - 16) / slot_bytes);
  if (chunk < 1) chunk = 1;
  if (chunk > geo.a_max) chunk = geo.a_max;
  geo.chunk_slots = chunk;
  const int smem = static_cast<int>(block_tile_bytes<XT, BT>(chunk, geo.m) + red_bytes);
  static int opted_in[kMaxDevices] = {0};
  if (smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = smem;
  }
  const int col_tiles = (geo.cd + BT - 1) / BT;
  if (col_tiles > 65535) return kErrBadShape;
  if (rows_per_block <= 0) {
    const int sms = device_attr<cudaDevAttrMultiProcessorCount>(dev);
    if (sms <= 0) return kErrBadShape;
    rows_per_block = auto_block_rows(geo, col_tiles, sms);
  }
  if (rows_per_block > kThreads || kThreads % rows_per_block) return kErrBadShape;
  geo.rows = rows_per_block;
  geo.slot_lanes = kThreads / rows_per_block;
  geo.parts = (geo.block_r + rows_per_block - 1) / rows_per_block;
  const long long blocks_x = static_cast<long long>(geo.r / geo.block_r) * geo.parts;
  if (blocks_x > 0x7fffffffLL) return kErrBadShape;
  dim3 grid(static_cast<unsigned>(blocks_x), col_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(active_groups, weights, indices, b, c, geo);
  return static_cast<int>(cudaGetLastError());
}

// Pick the column tile of B as launch_fold does for x's rows.
template <typename XT, bool FOLD, typename W>
int launch_block_fold(const int32_t* ag, W w, const int32_t* idx, const XT* b, float* c,
                      const BlockGeom& geo, int rows_per_block, cudaStream_t stream) {
  if (geo.cd <= 1) return launch_block_bt<XT, 1, FOLD, W>(ag, w, idx, b, c, geo, rows_per_block, stream);
  if (geo.cd <= 2) return launch_block_bt<XT, 2, FOLD, W>(ag, w, idx, b, c, geo, rows_per_block, stream);
  if (geo.cd <= 4) return launch_block_bt<XT, 4, FOLD, W>(ag, w, idx, b, c, geo, rows_per_block, stream);
  return launch_block_bt<XT, 8, FOLD, W>(ag, w, idx, b, c, geo, rows_per_block, stream);
}

template <typename XT, typename W>
int launch_block(const int32_t* ag, W w, const int32_t* idx, const XT* b, float* c,
                 const BlockGeom& geo, int duplicates, int rows_per_block,
                 cudaStream_t stream) {
  if (duplicates)   // the folding body at the widest tile only, as launch_xt
    return launch_block_bt<XT, 8, true, W>(ag, w, idx, b, c, geo, rows_per_block, stream);
  return launch_block_fold<XT, false, W>(ag, w, idx, b, c, geo, rows_per_block, stream);
}

// Shapes and strides the body takes; fills the geometry the launch does not
// choose itself.
inline bool make_block_geom(BlockGeom* geo, int r, int k, int cd, int rb, int a_max,
                            int block_r, int m, int ne, long long s_rb, long long s_j,
                            long long s_row, long long s_bk, long long s_bc, long long s_cr,
                            long long s_cc, int rows_fastest) {
  if (r < 1 || cd < 1 || rb < 1 || a_max < 1 || block_r < 1 || m < 1 || ne < 1 || ne > m ||
      k % m != 0 || static_cast<long long>(rb) * block_r != r)
    return false;
  if (s_rb < 0 || s_j < 0 || s_row < 0 || s_bk < 0 || s_bc < 0 || s_cr < 0 || s_cc < 0)
    return false;
  *geo = BlockGeom{r, cd, k / m, a_max, block_r, m, ne, s_rb, s_j, s_row, s_bk, s_bc,
                   s_cr, s_cc, 0, 0, 0, 0, rows_fastest};
  return true;
}

}  // namespace demm
