// The wide-x body of y = x @ W_sparse^T (Bx > 8, bfloat16 x), over the
// row-packed {values, indices} stream (O, G, pitch): the body behind every
// prefill chunk, whole-sequence prefill and the packed training forward.
// The arithmetic of demm_xwt_common.cuh, unchanged -- every value rounded to
// the activation type (K3: round(q x round(scale)), per row or per group),
// duplicate slots summed in that type in slot order (fold_slot), products and
// sums in float32, y in float32, a padded slot adding exactly 0, a tier
// view's slots past its prefix never multiplied.
//
// What held the gather body back at these widths: it tiles x in at most 8
// rows, so every block of 8 x rows reads the whole packed stream again from
// device memory (or L2), decodes every pair again (rounding, scale, the
// duplicate search) and adds 8 products per decoded pair.  At Bx = 32 the
// stream is read and decoded 4 times, at Bx = 2048 256 times.
//
// This body decodes each pair once per launch:
//
//   * Tile.  A CTA owns `rows` consecutive output rows and walks x's row
//     tiles of BT = 32, 64 or 128 rows.  A cluster of `split` = 1 or 2 CTAs
//     shares a row tile, each over half of the groups, so that each reads
//     half of x from L2; at many tiles the CTAs split them (`xsplit`,
//     grid.y) so that a CTA may own more rows.  About one CTA per SM.
//     (Clusters of 4 would halve x again, but on a 132-SM H100 only 30 of
//     them are resident at once: the 33rd ran as a second wave.)
//   * Pairs.  1-D bulk copies (TMA) bring the 16-byte windows around each
//     row's span of indices, values and K3's scales into shared memory --
//     no rule on their alignment -- counted on mbarriers, and the CTA
//     decodes them there into a 4-byte entry per read slot: the column in
//     the low 16 bits (K <= 65,536), the weight in the high 16 (the value
//     rounded, K3: times its rounded scale, rounded again, duplicates
//     folded: always a bfloat16 value).  Slots past a tier view's prefix
//     get no entry.  The rows go in rounds through the x stages' room (one
//     round where they fit), all decoded before the first x chunk is
//     staged.  (Decoding straight from device memory, 8 slots a thread in
//     flight, took 6-12 us a launch; issuing every chunk's copies at entry
//     and decoding each chunk in its own step, while the later ones were
//     still in flight, was 4-5 % slower at Bx = 32 than these rounds.)
//   * x.  In chunks of `chunk_groups` groups (K columns), two stages in
//     shared memory: each thread loads an 8-row x 8-column block of x with
//     16-byte loads into registers one chunk ahead, transposes it there and
//     stores it as 8 columns of [column][BT] bfloat16, so that the BT
//     activations of one column are contiguous.
//   * Compute.  512 threads: an item slot of BT / 8 lanes owns an item -- a
//     row and a part of its entries (`parts`: every parts-th entry of a
//     chunk, so that items fill the slots at O / SMs rows) -- and lane l
//     holds x rows [8 l, 8 l + 8) of the tile: per entry one broadcast load
//     of the entry, one 16-byte load of the column's 8 activations, 8
//     products.  Entries go in batches of kWideBatch whose loads are issued
//     together.  At most 128 items a CTA, their float32 sums kept in
//     registers over the whole K walk.  At the tile's end the parts' sums
//     meet in shared memory (over the x stages) and are added in part order;
//     in a cluster each CTA pushes the peer's rows of them into the peer's
//     inbox, and after one cluster barrier adds rank 0's sum and rank 1's
//     in that order; one writer per y element, rows contiguous: no atomics,
//     the same order every run.
//
// Bound on an H100: at Bx = 32 the packed bytes over device-memory bandwidth
// (one pass) and x's reads from L2 (once per CTA of a cluster); at Bx = 2048
// the float32 multiply-adds on the CUDA cores, each fed by a 2-byte
// shared-memory read of x and a conversion, so the issue rate, not the 67
// TFLOP/s peak, is this body's ceiling there.  (Tensor cores on a dense
// scatter tile would multiply x's columns that no slot names by 0, and a
// draft tier's x may hold inf there: the port's tier check forbids it.)
//
// The sizes are __host__ __device__ helpers a CPU build of the header can
// check.  DEMM_WIDE_NO_PRODUCTS (no products: decode and staging only) and
// DEMM_WIDE_NO_PAIRS (no packed byte read: every entry weight 0 at its
// group's column 0) are measurement builds for timing the body in pieces,
// never the library's.

#pragma once

#include <cooperative_groups.h>

#include "demm_xwt_common.cuh"
#include "hopper_async.cuh"

namespace demm {

constexpr int kWideThreads = 512;
constexpr int kWideLaneRows = 8;        // x rows of a tile a lane holds: one 16-byte load
constexpr int kWideMaxItems = 128;      // items (so rows) of a CTA, their sums in registers
constexpr int kWideMinBx = 9;           // the bulk body takes Bx <= 8
constexpr int kWideMaxParts = 8;
constexpr int kWideChunkElems = 32768;  // BT x chunk columns: one 8 x 8 block per thread
constexpr int kWideMaxXsplit = 4;       // CTAs along x's tiles the launcher picks at most
constexpr int kWideMaxSplit = 2;        // CTAs of a cluster along K
constexpr int kWideBatch = 4;           // entries whose loads a lane issues together
constexpr int kWideMaxK = 65536;        // an entry holds its column in 16 bits
constexpr int kWideHeadBytes = 16;      // the pairs' mbarrier, padded

struct WideGeom {
  int bx, k, o, g, m, ne;
  int pitch;          // slots stored per group (ne of them are read)
  int rows;           // output rows per CTA
  int parts;          // items per row (wide_parts)
  int chunk_groups;   // groups per x chunk (wide_plan)
  int xsplit;         // CTAs along x's row tiles (grid.y)
  int split;          // CTAs of a cluster along K, each over G / split groups
  int vbytes;         // bytes of a stored value: 4, 2 or 1
  int scols;          // K3's scale columns: 1 (per row) or G (per group); 0: no scales
  int batch_rows;     // rows whose pairs one decode round copies (wide_plan)
};

// The x tile (rows) for `bx` rows when the launcher leaves it open: the
// smallest of 32, 64, 128 that covers them, 128 beyond.
__host__ __device__ inline int wide_auto_tile(int bx) {
  return bx <= 32 ? 32 : bx <= 64 ? 64 : 128;
}

// Groups of CTA `s` of a cluster of `split` along K: [wide_g0(s), wide_g0(s + 1)).
__host__ __device__ inline int wide_g0(int g, int split, int s) {
  return static_cast<int>(static_cast<long long>(g) * s / split);
}

// Entries a row of `gn` read slots takes: an odd count, so that the item
// slots of a warp, reading one entry each of consecutive rows, meet
// distinct banks.
__host__ __device__ inline int wide_dec_stride(int gn) { return gn | 1; }

// Bytes of the decoded entries of `rows` rows of `gn` read slots (4 each:
// the column in the low 16 bits, the bfloat16 weight in the high 16),
// rounded up to 16.
__host__ __device__ inline size_t wide_dec_bytes(int rows, int gn) {
  return (static_cast<size_t>(rows) * wide_dec_stride(gn) * 4 + 15) & ~static_cast<size_t>(15);
}

// One x stage: `cols` columns of BT bfloat16 activations.
__host__ __device__ inline size_t wide_stage_bytes(int bt, int cols) {
  return static_cast<size_t>(cols) * bt * 2;
}

// The parts' sums at a tile's end: parts x rows x (BT + 1) float32 (a row
// padded by one so that the adding threads' reads meet distinct banks).
__host__ __device__ inline size_t wide_sums_bytes(int bt, int rows, int parts) {
  return static_cast<size_t>(parts) * rows * (bt + 1) * 4;
}

// In a cluster, the inbox of the peer's sums of this CTA's rows (half of
// them, rounded up), padded as the sums, rounded up to 16 bytes; a region of
// its own, so that a push never lands on pairs or x still in use.
__host__ __device__ inline size_t wide_inbox_bytes(int bt, int rows, int split) {
  return split > 1 ? (static_cast<size_t>((rows + 1) / 2) * (bt + 1) * 4 + 15) & ~static_cast<size_t>(15)
                   : 0;
}

// The 16-byte-aligned window that holds any `bytes` consecutive bytes.
__host__ __device__ inline size_t wide_window(size_t bytes) { return ((bytes + 15) / 16 + 1) * 16; }

// Scale floats a row copies: none, its one scale, or its `groups` scales.
__host__ __device__ inline int wide_row_scales(int scols, int groups) {
  return scols == 0 ? 0 : scols == 1 ? 1 : groups;
}

// One row's copied windows: `lr` indices, `lr` values of `vbytes` and
// `nscales` scales.
__host__ __device__ inline size_t wide_raw_row_bytes(int lr, int vbytes, int nscales) {
  return wide_window(static_cast<size_t>(lr) * 4) + wide_window(static_cast<size_t>(lr) * vbytes) +
         (nscales ? wide_window(static_cast<size_t>(nscales) * 4) : 0);
}

// Dynamic shared memory of a launch at the least room: the mbarrier, the
// entries of a CTA's rows over its groups (`gn` read slots a row), the
// inbox, then a room that holds in turn the pairs of a round (at least one
// row's, `raw_row` bytes), two x stages and the parts' sums.
__host__ __device__ inline size_t wide_smem_bytes(int bt, int rows, int parts, int split, int gn,
                                                  int cols, size_t raw_row) {
  size_t room = 2 * wide_stage_bytes(bt, cols);
  const size_t sums = wide_sums_bytes(bt, rows, parts);
  if (sums > room) room = sums;
  if (raw_row > room) room = raw_row;
  return kWideHeadBytes + wide_dec_bytes(rows, gn) + wide_inbox_bytes(bt, rows, split) + room;
}

// Item slots of a CTA at an x tile of `bt` rows: BT / 8 lanes an item.
__host__ __device__ inline int wide_slots(int bt) { return kWideThreads * kWideLaneRows / bt; }

// Items per row: the count in 1..kWideMaxParts whose rows x parts items fill
// the item slots' passes best (ties: fewer), within kWideMaxItems items.
__host__ __device__ inline int wide_parts(int rows, int bt) {
  const int nslots = wide_slots(bt);
  int best = 1;
  long long best_num = 0, best_den = 1;
  for (int p = 1; p <= kWideMaxParts && rows * p <= kWideMaxItems; ++p) {
    const int items = rows * p;
    const int slots = (items + nslots - 1) / nslots * nslots;
    if (static_cast<long long>(items) * best_den > best_num * slots) {
      best = p;
      best_num = items;
      best_den = slots;
    }
  }
  return best;
}

// Stage plan: fills parts, chunk_groups (the most groups per chunk, at most
// a CTA's G / split, whose stages -- BT x columns within kWideChunkElems --
// fit beside the entries), batch_rows (the room grown, as far as shared
// memory allows, until every row's pairs are copied and decoded in one
// round) and the shared memory; false when not even one group fits
// (kernels/demm_xwT.wide_plan states the same plan, xwt_body_of its one-row
// case).
__host__ __device__ inline bool wide_plan(WideGeom* geo, int bt, int smem_limit, int* smem) {
  if (geo->rows < 1 || geo->rows > kWideMaxItems || geo->split < 1 ||
      geo->split > kWideMaxSplit || geo->split > geo->g)
    return false;
  const int gmax = (geo->g + geo->split - 1) / geo->split;
  const int gn = gmax * geo->ne;
  geo->parts = wide_parts(geo->rows, bt);
  int cg = kWideChunkElems / (bt * geo->m);
  if (cg > gmax) cg = gmax;
  const size_t raw_row =
      wide_raw_row_bytes(gmax * geo->pitch, geo->vbytes, wide_row_scales(geo->scols, gmax));
  while (cg >= 1 && wide_smem_bytes(bt, geo->rows, geo->parts, geo->split, gn, cg * geo->m,
                                    raw_row) > static_cast<size_t>(smem_limit))
    --cg;
  if (cg < 1) return false;
  geo->chunk_groups = cg;
  const size_t dec = kWideHeadBytes + wide_dec_bytes(geo->rows, gn) +
                     wide_inbox_bytes(bt, geo->rows, geo->split);
  size_t room =
      wide_smem_bytes(bt, geo->rows, geo->parts, geo->split, gn, cg * geo->m, raw_row) - dec;
  const size_t all = raw_row * geo->rows;
  const size_t most = (static_cast<size_t>(smem_limit) - dec) & ~static_cast<size_t>(15);
  if (room < all) room = all < most ? all : most;
  geo->batch_rows = static_cast<int>(room / raw_row);
  if (geo->batch_rows > geo->rows) geo->batch_rows = geo->rows;
  *smem = static_cast<int>(dec + room);
  return true;
}

// Rows per CTA, CTAs along K (a cluster) and along x when the caller leaves
// them open: about one CTA per SM, where x is read from L2 once per CTA of
// rows -- so as many CTAs as fit share that read, up to kWideMaxXsplit
// along x's tiles and kWideMaxSplit along K (the most in all first, then
// the fewest along K: their sums cost a reduction), each CTA owning that
// many times O / SMs rows, as far as 128 rows and shared memory allow;
// where even O / SMs rows do not fit, fewer (more than one wave).  Given
// rows (split 1): as many CTAs along x as keep one wave.
inline void wide_auto_grid(WideGeom* geo, int bt, int sm_count, int smem_limit) {
  const int ntiles = (geo->bx + bt - 1) / bt;
  const int xs_top = ntiles < kWideMaxXsplit ? ntiles : kWideMaxXsplit;
  const int sp_top = geo->g < kWideMaxSplit ? geo->g : kWideMaxSplit;
  if (geo->rows > 0) {
    geo->split = 1;
    const int ctas = (geo->o + geo->rows - 1) / geo->rows;
    const int xs = sm_count / ctas;
    geo->xsplit = xs < 1 ? 1 : (xs > xs_top ? xs_top : xs);
    return;
  }
  int smem = 0;
  for (int prod = xs_top * sp_top; prod >= 1; --prod) {
    for (int sp = 1; sp <= sp_top; ++sp) {
      if (prod % sp || prod / sp > xs_top) continue;
      WideGeom t = *geo;
      t.split = sp;
      t.xsplit = prod / sp;
      long long rows = (static_cast<long long>(geo->o) * prod + sm_count - 1) / sm_count;
      t.rows = static_cast<int>(rows > geo->o ? geo->o : rows);
      if (t.rows < 1) t.rows = 1;
      if (wide_plan(&t, bt, smem_limit, &smem)) {
        *geo = t;
        return;
      }
    }
  }
  // not even O / SMs rows fit: halve them (more than one wave)
  WideGeom t = *geo;
  t.split = 1;
  t.xsplit = 1;
  long long rows = (static_cast<long long>(geo->o) + sm_count - 1) / sm_count;
  t.rows = static_cast<int>(rows > kWideMaxItems ? kWideMaxItems : rows);
  while (t.rows > 1 && !wide_plan(&t, bt, smem_limit, &smem)) t.rows = (t.rows + 1) / 2;
  *geo = t;
}

// bfloat16 pairs -> two floats (element 0 in the low half).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The 8 bfloat16 activations of one column a lane holds (one 16-byte
// load), and their products with one weight.
struct WideCol {
  uint4 a;
  __device__ __forceinline__ void load(const unsigned char* p) {
    a = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void fma(float (&acc)[kWideLaneRows], float w) const {
    const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(w, bf16_lo(u[i]), acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, bf16_hi(u[i]), acc[2 * i + 1]);
    }
  }
};

// An entry's weight and the byte offset of its column's x vector in a stage
// whose first column is the one at byte `kofs` of the K walk.
__device__ __forceinline__ float wide_weight(uint32_t e) { return __uint_as_float(e & 0xffff0000u); }
template <int BT>
__device__ __forceinline__ int wide_col_offset(uint32_t e, int kofs) {
  return static_cast<int>(e & 0xffffu) * (BT * 2) - kofs;
}

// One CTA per SM (its shared memory allows no more), so up to 128
// registers a thread.  A cluster of geo.split CTAs shares a row tile, each
// over its own groups; with split 1 the cluster is the CTA alone.
template <int BT, typename W>
__global__ void __launch_bounds__(kWideThreads, 1)
xwt_wide_kernel(const __nv_bfloat16* __restrict__ x, W weights,
                const int32_t* __restrict__ indices, float* __restrict__ y, WideGeom geo,
                int fold) {
  namespace cg = cooperative_groups;
  using XT = __nv_bfloat16;
  constexpr int V = kWideLaneRows;
  constexpr int kLanes = BT / V;                  // lanes of an item slot
  constexpr int kSlots = kWideThreads / kLanes;   // item slots
  constexpr int kPasses = kWideMaxItems / kSlots; // items a slot holds at most
  constexpr int kSlices = BT / 8;                 // 8-row slices of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int split = geo.split;
  const int rank = static_cast<int>(blockIdx.x) % split;    // this CTA's K part
  const int tile_r = static_cast<int>(blockIdx.x) / split;
  const int gs0 = wide_g0(geo.g, split, rank);              // this CTA's groups
  const int gs1 = wide_g0(geo.g, split, rank + 1);
  const int gmax = (geo.g + split - 1) / split;
  const int gn_max = wide_dec_stride(gmax * geo.ne);        // entries a row, allocated
  const int gn = (gs1 - gs0) * geo.ne;                      // entries a row, used
  const int row0 = tile_r * geo.rows;
  const int nrows = min(geo.rows, geo.o - row0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);              // a round's pairs
  uint32_t* dec = reinterpret_cast<uint32_t*>(smem_raw + kWideHeadBytes);   // [rows][gn_max]
  float* inbox = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(dec) +
                                          wide_dec_bytes(geo.rows, gmax * geo.ne));
  unsigned char* xs = reinterpret_cast<unsigned char*>(inbox) +
                      wide_inbox_bytes(BT, geo.rows, split);             // the room
  float* sums = reinterpret_cast<float*>(xs);     // [parts][nrows][BT + 1], over the stages
  const int cols_max = geo.chunk_groups * geo.m;
  const size_t stage_b = wide_stage_bytes(BT, cols_max);
  const int nchunks = (gs1 - gs0 + geo.chunk_groups - 1) / geo.chunk_groups;
  const int ntiles = (geo.bx + BT - 1) / BT;
  const int my_tiles = blockIdx.y < ntiles
                           ? (ntiles - static_cast<int>(blockIdx.y) + geo.xsplit - 1) / geo.xsplit
                           : 0;
  const int steps = my_tiles * nchunks;           // (tile, chunk) pairs, tiles outer
  // Every CTA walks its chunks from its own place and its columns from its
  // own place in a chunk, so that 132 CTAs do not all ask L2 for the same
  // lines of x at once.
  const int c_rot = tile_r % max(nchunks, 1);
  auto chunk_g0 = [&](int step) {
    int c = step % nchunks + c_rot;
    c = c >= nchunks ? c - nchunks : c;
    return gs0 + c * geo.chunk_groups;
  };

  // The staging block of this thread: rows [8 bs, 8 bs + 8) of the tile,
  // columns [8 cv, 8 cv + 8) of the chunk, rotated by the CTA.
  const int bs = threadIdx.x % kSlices;
  const int cv_t = threadIdx.x / kSlices;
  uint4 raw[8];
  auto vec_of = [&](int g0, int* k0) {   // this thread's column vector of the chunk at g0, or -1
    *k0 = g0 * geo.m;
    const int ncv = min(geo.chunk_groups, gs1 - g0) * geo.m / 8;
    if (cv_t >= ncv) return -1;
    const int v = cv_t + (tile_r * 37) % ncv;
    return v >= ncv ? v - ncv : v;
  };
  auto load = [&](int step) {
    const int b0 = (static_cast<int>(blockIdx.y) + (step / nchunks) * geo.xsplit) * BT;
    int k0 = 0;
    const int v = vec_of(chunk_g0(step), &k0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int b = b0 + bs * 8 + r;
      raw[r] = v >= 0 && b < geo.bx
                   ? __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(b) * geo.k +
                                                          k0 + v * 8))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&](int step) {
    int k0 = 0;
    const int v = vec_of(chunk_g0(step), &k0);
    if (v < 0) return;
    unsigned char* at = xs + (step & 1) * stage_b + static_cast<size_t>(v) * 8 * BT * 2 + bs * 16;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(raw);   // w[4 r + i]: row r, columns 2i, 2i + 1
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t sel = (e & 1) ? 0x7632u : 0x5410u;
      const int i = e >> 1;
      uint4 col;
      col.x = __byte_perm(w[0 * 4 + i], w[1 * 4 + i], sel);
      col.y = __byte_perm(w[2 * 4 + i], w[3 * 4 + i], sel);
      col.z = __byte_perm(w[4 * 4 + i], w[5 * 4 + i], sel);
      col.w = __byte_perm(w[6 * 4 + i], w[7 * 4 + i], sel);
      *reinterpret_cast<uint4*>(at + e * BT * 2) = col;
    }
  };
  // the peer of a cluster is running before its shared memory is touched
  // (the first push waits on this arrival)
  if (split > 1) hopper::cluster_arrive_relaxed();
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (steps > 0) load(0);   // in flight while the pairs are decoded

  // Pairs, in rounds of batch_rows rows through the room, all decoded before
  // the first step.  spans gives row o's spans of indices, values and
  // scales over the CTA's groups; room() the row's place in the room, the
  // windows of its indices, values and scales at chunk 0, ci and ci + cv (of
  // 16 bytes).  Each window comes by one bulk copy counted on the barrier;
  // a warp a row then decodes it, its lanes over the read slots (slot j:
  // group j / ne, from a float reciprocal, exact below 2^21).
  const size_t row_slots = static_cast<size_t>(geo.g) * geo.pitch;
  const char* vbase = weights.value_bytes();
  const float* sbase = nullptr;
  if constexpr (W::kHasScales) sbase = weights.scale_ptr();
  const int lr = (gs1 - gs0) * geo.pitch;                      // slots of a row's span
  const int nsc = wide_row_scales(geo.scols, gs1 - gs0);       // scales of a row's span
  struct Spans { const char *ib, *vb, *sb; };
  auto spans = [&](int o) {
    const size_t s0 = static_cast<size_t>(o) * row_slots + static_cast<size_t>(gs0) * geo.pitch;
    return Spans{reinterpret_cast<const char*>(indices + s0), vbase + s0 * geo.vbytes,
                 nsc ? reinterpret_cast<const char*>(sbase + static_cast<size_t>(o) * geo.scols +
                                                     (geo.scols == 1 ? 0 : gs0))
                     : nullptr};
  };
  const int ci = static_cast<int>(wide_window(static_cast<size_t>(gmax) * geo.pitch * 4) / 16);
  const int cv =
      static_cast<int>(wide_window(static_cast<size_t>(gmax) * geo.pitch * geo.vbytes) / 16);
  const size_t rb = wide_raw_row_bytes(gmax * geo.pitch, geo.vbytes,
                                       wide_row_scales(geo.scols, gmax));   // room bytes a row
  const int warp = threadIdx.x / 32;
  const int ln = threadIdx.x % 32;
  constexpr int kWarps = kWideThreads / 32;
  const float inv_ne = 1.f / static_cast<float>(geo.ne);
  for (int rb0 = 0, k = 0; rb0 < nrows; rb0 += geo.batch_rows, ++k) {
    const int rn = min(geo.batch_rows, nrows - rb0);
#ifndef DEMM_WIDE_NO_PAIRS
    if (k > 0) hopper::fence_proxy_async();   // the last round's reads before these copies
    for (int i = threadIdx.x; i < rn * 3; i += kWideThreads) {
      const int r = i / 3;
      const int w = i - r * 3;                // 0: indices, 1: values, 2: scales
      const Spans sp = spans(row0 + rb0 + r);
      const char* b = w == 0 ? sp.ib : w == 1 ? sp.vb : sp.sb;
      const size_t bytes =
          static_cast<size_t>(w == 0 ? lr * 4 : w == 1 ? lr * geo.vbytes : nsc * 4);
      if (bytes == 0) continue;
      const uintptr_t a = reinterpret_cast<uintptr_t>(b) & ~static_cast<uintptr_t>(15);
      const uint32_t len = static_cast<uint32_t>(
          ((reinterpret_cast<uintptr_t>(b) + bytes + 15) & ~static_cast<uintptr_t>(15)) - a);
      hopper::mbar_expect_tx(bar, len);
      hopper::bulk_g2s(xs + r * rb + (w == 0 ? 0 : w == 1 ? ci : ci + cv) * 16,
                       reinterpret_cast<const void*>(a), len, bar);
    }
    __syncthreads();   // every copy is announced on the barrier
    if (threadIdx.x == 0) hopper::mbar_arrive(bar);
    hopper::mbar_wait(bar, k & 1);
#endif
    for (int r = warp; r < rn; r += kWarps) {
      uint32_t* drow = dec + static_cast<size_t>(rb0 + r) * gn_max;
#ifndef DEMM_WIDE_NO_PAIRS
      const unsigned char* room = xs + r * rb;
      const Spans sp = spans(row0 + rb0 + r);
      const int32_t* irow =
          reinterpret_cast<const int32_t*>(room + (reinterpret_cast<uintptr_t>(sp.ib) & 15));
      const unsigned char* vrow = room + ci * 16 + (reinterpret_cast<uintptr_t>(sp.vb) & 15);
      const float* srow = nullptr;
      if constexpr (W::kHasScales)
        srow = reinterpret_cast<const float*>(room + (ci + cv) * 16 +
                                              (reinterpret_cast<uintptr_t>(sp.sb) & 15)) -
               (geo.scols == 1 ? 0 : gs0);
      const W wr = weights.on(vrow, srow);
#endif
      for (int j = ln; j < gn; j += 32) {
        const int gl = static_cast<int>((static_cast<float>(j) + 0.5f) * inv_ne);
        const int g = gs0 + gl;
#ifdef DEMM_WIDE_NO_PAIRS
        drow[j] = static_cast<uint32_t>(g * geo.m);
#else
        const int n = j - gl * geo.ne;
        const int slot = gl * geo.pitch + n;
        const int idx = irow[slot];
        const float s = fold ? fold_slot<true, XT>(wr, irow, slot - n, n, geo.ne, idx)
                             : fold_slot<false, XT>(wr, irow, slot - n, n, geo.ne, idx);
        // the weight is a bfloat16 value: its float's low half is 0
        drow[j] = (__float_as_uint(wr.finish(s, wr.xwt_scale(0, g))) & 0xffff0000u) |
                  static_cast<uint32_t>(g * geo.m + idx);
#endif
      }
    }
    __syncthreads();   // the room is read before the next round or x lands on it
  }

  const int slot = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int items = nrows * geo.parts;
  float acc[kPasses][V];
  for (int s = 0; s < steps; ++s) {
    const int c = s % nchunks;
    if (c == 0) {
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[ps][v] = 0.f;
    }
    store(s);
    __syncthreads();   // the chunk is staged
    if (s + 1 < steps) load(s + 1);

    const int g0 = chunk_g0(s);
    const int g1 = min(g0 + geo.chunk_groups, gs1);
    // byte offset of column k0 in the entries' frame: the chunk's columns
    // start at k0
    const int kofs = g0 * geo.m * BT * 2;
    const unsigned char* xb = xs + (s & 1) * stage_b + lane * V * 2;
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
      const int item = ps * kSlots + slot;
      if (item < items) {
        const int r = item / geo.parts;
        const int p = item - r * geo.parts;
        const uint32_t* d = dec + static_cast<size_t>(r) * gn_max;
        const int hi = (g1 - gs0) * geo.ne;
#ifndef DEMM_WIDE_NO_PRODUCTS
        // kWideBatch entries at a time, every load of a batch issued before
        // its products (a loop that may stop after any entry keeps each
        // entry's two dependent loads apart)
        const int step = geo.parts;
        int j = (g0 - gs0) * geo.ne + p;
        for (; j + (kWideBatch - 1) * step < hi; j += kWideBatch * step) {
          uint32_t e[kWideBatch];
#pragma unroll
          for (int u = 0; u < kWideBatch; ++u) e[u] = d[j + u * step];
          WideCol col[kWideBatch];
#pragma unroll
          for (int u = 0; u < kWideBatch; ++u) col[u].load(xb + wide_col_offset<BT>(e[u], kofs));
#pragma unroll
          for (int u = 0; u < kWideBatch; ++u) col[u].fma(acc[ps], wide_weight(e[u]));
        }
        for (; j < hi; j += step) {
          const uint32_t e = d[j];
          WideCol col;
          col.load(xb + wide_col_offset<BT>(e, kofs));
          col.fma(acc[ps], wide_weight(e));
        }
#else
        if (hi < 0) acc[ps][0] += wide_weight(d[0]);   // keeps the entries live
#endif
      }
    }

    if (c == nchunks - 1) {
      // The tile's end: the parts' sums meet in shared memory (over the x
      // stages) and are added in part order; then each CTA of the cluster
      // adds its share of the rows, rank 0's sum before rank 1's, and writes
      // them, one writer per y element, rows contiguous.
      __syncthreads();   // every product of the tile is done with the stages
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const int item = ps * kSlots + slot;
        if (item < items) {
          const int r = item / geo.parts;
          const int p = item - r * geo.parts;
          float* dst = sums + (static_cast<size_t>(p) * nrows + r) * (BT + 1) + lane * V;
#pragma unroll
          for (int v = 0; v < V; ++v) dst[v] = acc[ps][v];
        }
      }
      __syncthreads();
      if (geo.parts > 1) {
        for (int i = threadIdx.x; i < nrows * (BT + 1); i += kWideThreads) {
          float sum = sums[i];
          for (int p = 1; p < geo.parts; ++p)
            sum += sums[static_cast<size_t>(p) * nrows * (BT + 1) + i];
          sums[i] = sum;
        }
      }
      const int b0 = (static_cast<int>(blockIdx.y) + (s / nchunks) * geo.xsplit) * BT;
      const int r0 = wide_g0(nrows, split, rank);               // this CTA's rows to write
      const int rn = wide_g0(nrows, split, rank + 1) - r0;
      if (split > 1) {
        // push the peer's rows of these sums into its inbox, then one
        // cluster barrier: every push has landed
        cg::cluster_group cluster = cg::this_cluster();
        const int peer = rank ^ 1;
        const int pr0 = wide_g0(nrows, split, peer);
        const int prn = wide_g0(nrows, split, peer + 1) - pr0;
        float* to = cluster.map_shared_rank(inbox, peer);
        __syncthreads();   // the parts are added
        if (s < nchunks) hopper::cluster_wait();   // the first push: the peer has started
        for (int i = threadIdx.x; i < prn * BT; i += kWideThreads) {
          const int r = i / BT;
          const int b = i - r * BT;
          to[r * (BT + 1) + b] = sums[static_cast<size_t>(pr0 + r) * (BT + 1) + b];
        }
        cluster.sync();
      } else {
        __syncthreads();
      }
      for (int i = threadIdx.x; i < rn * BT; i += kWideThreads) {
        const int b = i / rn;
        const int r = i - b * rn;
        if (b0 + b >= geo.bx) break;   // i grows with b
        float sum = sums[static_cast<size_t>(r0 + r) * (BT + 1) + b];
        if (split > 1) {   // rank 0's sum first
          const float other = inbox[r * (BT + 1) + b];
          sum = rank == 0 ? sum + other : other + sum;
        }
        y[static_cast<size_t>(b0 + b) * geo.o + row0 + r0 + r] = sum;
      }
      // the sums and the inbox are read before the next tile's x lands on
      // them or the peer pushes the next tile's sums
      if (s + 1 < steps) {
        if (split > 1) cg::this_cluster().sync(); else __syncthreads();
      }
    }
  }
}

// Start the kernel, opting in to its shared memory once per size reached;
// a cluster of geo.split CTAs along x where split > 1.
template <int BT, typename W>
static int start_wide(const __nv_bfloat16* x, W weights, const int32_t* indices, float* y,
                      const WideGeom& geo, int fold, int smem, int dev, cudaStream_t stream) {
  auto kernel = xwt_wide_kernel<BT, W>;
  static int opted_in[kMaxDevices] = {0};
  if (smem > opted_in[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((geo.o + geo.rows - 1) / geo.rows * geo.split),
                     static_cast<unsigned>(geo.xsplit));
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = geo.split > 1 ? 1 : 0;
  last_launch_smem = smem;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, weights, indices, y, geo, fold);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Whether the wide body can take these arguments: Bx > 8; x's rows (K
// bfloat16 activations) and every group (M columns) 16-byte multiples and x
// 16-byte aligned, since x moves in 16-byte loads of 8 columns; one group
// of the widest tile the launch takes within kWideChunkElems.  The pairs
// and scales are copied in 16-byte windows around their spans: no rule on
// them.  The choice of body is made by the caller (kernels/demm_xwT.xwt_body
// states the rule); this check only asserts it.  (Shared memory is checked
// by the plan.)
inline bool wide_takes(const WideGeom& g, const void* x, int bt) {
  return g.bx >= kWideMinBx && g.ne >= 1 && g.ne <= g.pitch && g.k % 8 == 0 && g.m % 8 == 0 &&
         g.k <= kWideMaxK && bt * g.m <= kWideChunkElems &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// `tile`: x rows per tile, 32, 64 or 128 (0: wide_auto_tile); geo.rows 0:
// the launcher's choice (wide_auto_grid; given rows, no cluster).
template <typename W>
int launch_wide(const __nv_bfloat16* x, W weights, const int32_t* indices, float* y,
                WideGeom geo, int duplicates, int tile, cudaStream_t stream) {
  const int bt = tile ? tile : wide_auto_tile(geo.bx);
  if ((bt != 32 && bt != 64 && bt != 128) || !wide_takes(geo, x, bt) || geo.rows < 0)
    return kErrBadShape;
  geo.vbytes = W::kValueBytes;
  geo.scols = 0;
  if constexpr (W::kHasScales) geo.scols = weights.scale_cols;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrBadShape;
  const int smem_limit = device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(dev);
  const int sms = device_attr<cudaDevAttrMultiProcessorCount>(dev);
  if (smem_limit <= 0 || sms <= 0) return kErrBadShape;
  if (geo.rows > geo.o) geo.rows = geo.o;
  wide_auto_grid(&geo, bt, sms, smem_limit);
  int smem = 0;
  if (!wide_plan(&geo, bt, smem_limit, &smem)) return kErrGroupTooWide;
  const int fold = duplicates ? 1 : 0;
  if (bt == 32) return start_wide<32, W>(x, weights, indices, y, geo, fold, smem, dev, stream);
  if (bt == 64) return start_wide<64, W>(x, weights, indices, y, geo, fold, smem, dev, stream);
  return start_wide<128, W>(x, weights, indices, y, geo, fold, smem, dev, stream);
}

}  // namespace demm
