// The bulk-copy cluster body of the two-level block spmm at serving batch
// (Cd = Bx <= 8, B = x^T): C = A_block @ B, the arithmetic of
// demm_block_spmm_common.cuh (scatter rows in B's type, duplicate slots summed
// in that type in slot order, the int8 scale applied after the sum, products
// and sums in float32).
//
// What it is built on: for one row block, the values and indices
// (A_max, block_r, Ne) and the scales (A_max, block_r) are each one contiguous
// span, so a CTA's share of them moves with one bulk copy (TMA, 1-D) each.
//
//   * Split.  A thread block cluster of `csize` CTAs owns one row block; CTA
//     q takes the list slots [q * per, (q + 1) * per), per = ceil(A_max /
//     csize).
//   * Copies in flight.  At entry one thread issues, against one mbarrier,
//     the bulk copies of the CTA's slice of values, indices and scales; a
//     slice larger than shared memory goes in chunks through a ring of two
//     stages.  Meanwhile every thread loads, 16 bytes at a time, x's
//     segments (Cd of M elements each) for only the groups its own slots
//     list.  (A bulk copy per segment, the first version, cost about 0.1 us
//     of the copy engine per 96-160-byte segment, one after another.)  Each
//     CTA stages 1/csize of x, not all of it.
//   * Compute.  Threads own (row, slot lane) pairs and read their pairs from
//     shared memory; the scale of a (row, slot) is read once.
//   * Reduction.  The slot lanes of a row add up through shared memory, then
//     the csize partial (block_r x Cd) tiles through distributed shared
//     memory: CTA q owns outputs [q P, (q + 1) P) of the E = block_r x Cd (P
//     = ceil(E / csize)); every CTA writes its partial of them into q's
//     shared memory, one cluster barrier, and q adds the csize partials in
//     CTA order and writes C.  Deterministic, no atomics, no second launch.
//     (A split cluster barrier -- arrive at entry, wait before the first
//     remote write -- guarantees that every CTA is running before its shared
//     memory is written, at the cost of one wait that has long completed.)
//
// Padded list slots (group ids outside [0, G)) add nothing; padding that
// names group 0 has all-zero values and adds exactly 0.
//
// Bound on an H100: the packed bytes over device-memory bandwidth, as for the
// gather body; this body's job is to have all of them in flight at once.
//
// The sizes and the split are __host__ __device__ helpers a CPU build of the
// header can check; the copies, barriers and cluster calls are not.

#pragma once

#include <cooperative_groups.h>

#include "demm_block_spmm_common.cuh"
#include "hopper_async.cuh"

namespace demm {

struct ClusterGeom {
  int r, cd, groups, a_max, block_r, m, ne;
  long long s_bc;          // elements between B's columns (x's rows); B's rows are contiguous
  long long s_cr, s_cc;    // element strides of C
  int csize;               // CTAs per row block (the cluster)
  int per_cta;             // list slots per CTA
  int chunk;               // list slots per stage
  int stages;              // 1 (the whole slice at once) or 2 (a ring)
  int lanes;               // slot lanes per row: kThreads / block_r
};

// Bytes of one list slot in a stage (values, indices, scales) and in the x
// buffer (Cd segments of M activations).
template <typename W>
__host__ __device__ inline size_t cl_slot_bytes(int block_r, int ne) {
  return static_cast<size_t>(block_r) * ne * W::kValueBytes +
         static_cast<size_t>(block_r) * ne * sizeof(int32_t) +
         (W::kHasScales ? static_cast<size_t>(block_r) * sizeof(float) : 0);
}
template <typename XT>
__host__ __device__ inline size_t cl_x_slot_bytes(int cd, int m) {
  return static_cast<size_t>(cd) * m * sizeof(XT);
}

// Shared memory before the stages: two barriers, the slot lanes' sums and the
// partials this CTA receives (csize x P <= block_r x bt + 8 floats).
__host__ __device__ inline size_t cl_fixed_bytes(int lanes, int block_r, int bt) {
  return 16 + (static_cast<size_t>(lanes + 1) * block_r * bt + 8) * sizeof(float);
}

// List slots [first, last) of CTA `rank` of a cluster.
__host__ __device__ inline void cl_slots(int a_max, int per_cta, int rank, int* first,
                                         int* last) {
  const long long f = static_cast<long long>(rank) * per_cta;
  *first = static_cast<int>(f < a_max ? f : a_max);
  *last = (*first + per_cta < a_max) ? *first + per_cta : a_max;
}

// Outputs per CTA: the row block's block_r x cd outputs (row fastest) in
// csize runs of this length; CTA q owns run q.
__host__ __device__ inline int cl_run(int block_r, int cd, int csize) {
  return (block_r * cd + csize - 1) / csize;
}

// CTAs per row block when the caller leaves the choice open: the smallest of
// 2, 4, 8 that gives every SM a CTA, else 8; never more than the list slots.
inline int cl_auto_csize(int rb, int a_max, int sm_count) {
  int c = 2;
  while (c < 8 && static_cast<long long>(rb) * c < sm_count) c <<= 1;
  return c < a_max ? c : a_max;
}

// Stage plan: the whole slice in one stage when it fits `smem_limit`, else
// two stages of as many slots as fit (the x buffer holds one chunk).  Fills
// per_cta / chunk / stages and the dynamic shared memory; false when not even
// one slot per stage fits.
inline bool cl_plan(ClusterGeom* geo, int bt, size_t slot_bytes, size_t x_slot_bytes,
                    int smem_limit, int* smem) {
  geo->per_cta = (geo->a_max + geo->csize - 1) / geo->csize;
  const size_t fixed = cl_fixed_bytes(geo->lanes, geo->block_r, bt);
  if (fixed + geo->per_cta * (slot_bytes + x_slot_bytes) <= static_cast<size_t>(smem_limit)) {
    geo->chunk = geo->per_cta;
    geo->stages = 1;
  } else {
    if (fixed + 2 * slot_bytes + x_slot_bytes > static_cast<size_t>(smem_limit)) return false;
    geo->chunk = static_cast<int>((smem_limit - fixed) / (2 * slot_bytes + x_slot_bytes));
    geo->stages = 2;
  }
  *smem = static_cast<int>(fixed + static_cast<size_t>(geo->chunk) *
                                       (geo->stages * slot_bytes + x_slot_bytes));
  return true;
}

template <typename XT, int BT, bool FOLD, typename W>
__global__ void __launch_bounds__(kThreads)
block_cluster_kernel(const int32_t* __restrict__ active_groups, W weights,
                     const int32_t* __restrict__ indices, const XT* __restrict__ b,
                     float* __restrict__ c, ClusterGeom geo) {
  namespace cg = cooperative_groups;
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rbi = blockIdx.x / geo.csize;
  int js, je;
  cl_slots(geo.a_max, geo.per_cta, rank, &js, &je);
  const int nchunks = (je - js + geo.chunk - 1) / geo.chunk;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);                  // [2]
  float* red = reinterpret_cast<float*>(smem_raw + 16);                    // [lanes][block_r][BT]
  float* recv = red + static_cast<size_t>(geo.lanes) * geo.block_r * BT;   // [csize][run]
  unsigned char* stages =
      reinterpret_cast<unsigned char*>(recv + static_cast<size_t>(geo.block_r) * BT + 8);
  const size_t vals_b = static_cast<size_t>(geo.chunk) * geo.block_r * geo.ne * W::kValueBytes;
  const size_t idx_b = static_cast<size_t>(geo.chunk) * geo.block_r * geo.ne * sizeof(int32_t);
  const size_t sc_b = W::kHasScales ? static_cast<size_t>(geo.chunk) * geo.block_r * sizeof(float) : 0;
  const size_t stage_b = vals_b + idx_b + sc_b;
  XT* xs = reinterpret_cast<XT*>(stages + geo.stages * stage_b);   // [chunk][cd][m]
  const size_t ag_row = static_cast<size_t>(rbi) * geo.a_max;

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  // Announce this CTA as running; the wait before the first remote write
  // below makes sure every CTA of the cluster is (the arrive overlaps the
  // copies and the compute).
  cluster_arrive_relaxed();

  // One thread: request chunk k of this CTA's slice of the weights into
  // stage k % 2.
  auto issue = [&](int k) {
    const int j0 = js + k * geo.chunk;
    const int n = min(geo.chunk, je - j0);
    unsigned char* at = stages + (k & 1) * stage_b;
    uint64_t* bar = &bars[k & 1];
    const size_t unit = (ag_row + j0) * geo.block_r;         // first (row block, slot, row)
    const uint32_t vb = static_cast<uint32_t>(static_cast<size_t>(n) * geo.block_r * geo.ne * W::kValueBytes);
    const uint32_t ib = static_cast<uint32_t>(static_cast<size_t>(n) * geo.block_r * geo.ne * sizeof(int32_t));
    const uint32_t sb = W::kHasScales ? static_cast<uint32_t>(n * geo.block_r * sizeof(float)) : 0;
    mbar_arrive_expect_tx(bar, vb + ib + sb);
    bulk_g2s(at, weights.value_bytes() + unit * geo.ne * W::kValueBytes, vb, bar);
    bulk_g2s(at + vals_b, indices + unit * geo.ne, ib, bar);
    if (W::kHasScales) bulk_g2s(at + vals_b + idx_b, weights.scale_ptr() + unit, sb, bar);
  };
  if (threadIdx.x == 0) {
    if (nchunks > 0) issue(0);
    if (nchunks > 1) issue(1);
  }
  // Every thread: x's segments of the groups chunk k lists, 16 bytes at a
  // time (a padded slot's group id outside [0, G) loads nothing).
  constexpr int kVec = 16 / sizeof(XT);
  const int vecs_per_seg = geo.m / kVec;
  auto stage_x = [&](int k) {
    const int j0 = js + k * geo.chunk;
    const int n = min(geo.chunk, je - j0);
    const int total = n * geo.cd * vecs_per_seg;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int seg = i / vecs_per_seg;
      const int v = i - seg * vecs_per_seg;
      const int l = seg / geo.cd;
      const int bb = seg - l * geo.cd;
      const int gid = active_groups[ag_row + j0 + l];
      if (gid < 0 || gid >= geo.groups) continue;
      reinterpret_cast<uint4*>(xs)[i] = *reinterpret_cast<const uint4*>(
          b + bb * geo.s_bc + static_cast<long long>(gid) * geo.m + v * kVec);
    }
  };

  const int r = threadIdx.x % geo.block_r;
  const int sl = threadIdx.x / geo.block_r;
  float acc[BT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) acc[bb] = 0.f;
  for (int k = 0; k < nchunks; ++k) {
    stage_x(k);
    __syncthreads();   // x of chunk k is in place
    mbar_wait(&bars[k & 1], (k >> 1) & 1);
    const int j0 = js + k * geo.chunk;
    const int n = min(geo.chunk, je - j0);
    const unsigned char* at = stages + (k & 1) * stage_b;
    const int32_t* idxs = reinterpret_cast<const int32_t*>(at + vals_b);
    const W ws = weights.on(at, reinterpret_cast<const float*>(at + vals_b + idx_b));
    for (int jl = sl; jl < n; jl += geo.lanes) {
      const int gid = active_groups[ag_row + j0 + jl];
      if (gid < 0 || gid >= geo.groups) continue;
      const size_t unit = static_cast<size_t>(jl) * geo.block_r + r;
      const size_t pairs = unit * geo.ne;
      const float scale = ws.scale_of(unit);
      const XT* xj = xs + static_cast<size_t>(jl) * geo.cd * geo.m;
      for (int nn = 0; nn < geo.ne; ++nn) {
        const int idx = idxs[pairs + nn];
        const float w = ws.finish_with(fold_slot<FOLD, XT>(ws, idxs, pairs, nn, geo.ne, idx), scale);
#pragma unroll
        for (int bb = 0; bb < BT; ++bb)
          if (bb < geo.cd) acc[bb] = fmaf(w, to_float<XT>(xj[bb * geo.m + idx]), acc[bb]);
      }
    }
    __syncthreads();   // stage k % 2 and the x buffer are free again
    if (threadIdx.x == 0 && k + 2 < nchunks) issue(k + 2);
  }

  // Slot lanes of a row, then the cluster's CTAs, each in a fixed order.
  float* mine = red + (static_cast<size_t>(sl) * geo.block_r + r) * BT;
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) mine[bb] = acc[bb];
  __syncthreads();
  cluster_wait();    // every CTA of the cluster is running: its shared memory may be written
  const int run = cl_run(geo.block_r, geo.cd, geo.csize);
  for (int e = threadIdx.x; e < geo.block_r * geo.cd; e += kThreads) {
    const int bb = e / geo.block_r;
    const int rr = e - bb * geo.block_r;
    float s = 0.f;
    for (int q = 0; q < geo.lanes; ++q) s += red[(static_cast<size_t>(q) * geo.block_r + rr) * BT + bb];
    const int owner = e / run;
    cluster.map_shared_rank(recv, owner)[rank * run + (e - owner * run)] = s;
  }
  cluster.sync();    // every partial has reached its owner; none is read remotely after
  const int e0 = rank * run;
  const int e1 = min(e0 + run, geo.block_r * geo.cd);
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const int bb = e / geo.block_r;
    const int rr = e - bb * geo.block_r;
    float s = 0.f;
    for (int q = 0; q < geo.csize; ++q) s += recv[q * run + (e - e0)];
    c[(static_cast<long long>(rbi) * geo.block_r + rr) * geo.s_cr +
      static_cast<long long>(bb) * geo.s_cc] = s;
  }
}

template <typename XT, int BT, bool FOLD, typename W>
static int launch_cluster_bt(const int32_t* ag, W w, const int32_t* idx, const XT* b, float* c,
                             ClusterGeom geo, cudaStream_t stream) {
  auto kernel = block_cluster_kernel<XT, BT, FOLD, W>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrBadShape;
  const int smem_limit = device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(dev);
  int smem = 0;
  if (smem_limit <= 0 ||
      !cl_plan(&geo, BT, cl_slot_bytes<W>(geo.block_r, geo.ne),
               cl_x_slot_bytes<XT>(geo.cd, geo.m), smem_limit, &smem))
    return kErrGroupTooWide;
  static int opted_in[kMaxDevices] = {0};
  if (smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = smem;
  }
  const long long blocks = static_cast<long long>(geo.r / geo.block_r) * geo.csize;
  if (blocks > 0x7fffffffLL) return kErrBadShape;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  last_launch_smem = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, ag, w, idx, b, c, geo);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Whether the cluster body can take these arguments: B = x^T with x's rows
// 16-byte aligned, Cd <= 8, every copied span a multiple of 16 bytes, the
// row block a power of two <= 256.  The choice of body is made by the caller
// (kernels/demm_q8.block_q8_body states the rule); this check only asserts
// it, refusing with a negative code what the copies cannot take.
template <typename XT, typename W>
inline bool cluster_takes(const ClusterGeom& g, const void* values, const int32_t* indices,
                          const float* scales, const XT* b) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return g.cd <= 8 && g.block_r <= kThreads && kThreads % g.block_r == 0 &&
         (static_cast<size_t>(g.block_r) * g.ne * W::kValueBytes) % 16 == 0 &&
         g.block_r % 4 == 0 && (static_cast<size_t>(g.m) * sizeof(XT)) % 16 == 0 &&
         (g.cd == 1 || (static_cast<size_t>(g.s_bc) * sizeof(XT)) % 16 == 0) &&
         aligned(values) && aligned(indices) && (!W::kHasScales || aligned(scales)) && aligned(b);
}

template <typename XT, typename W>
int launch_cluster(const int32_t* ag, W w, const int32_t* idx, const XT* b, float* c,
                   const ClusterGeom& geo, int duplicates, cudaStream_t stream) {
  if (duplicates) return launch_cluster_bt<XT, 8, true, W>(ag, w, idx, b, c, geo, stream);
  if (geo.cd <= 1) return launch_cluster_bt<XT, 1, false, W>(ag, w, idx, b, c, geo, stream);
  if (geo.cd <= 2) return launch_cluster_bt<XT, 2, false, W>(ag, w, idx, b, c, geo, stream);
  if (geo.cd <= 4) return launch_cluster_bt<XT, 4, false, W>(ag, w, idx, b, c, geo, stream);
  return launch_cluster_bt<XT, 8, false, W>(ag, w, idx, b, c, geo, stream);
}

}  // namespace demm
