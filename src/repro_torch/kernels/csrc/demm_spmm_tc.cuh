// K5 at wide B: the tiled tensor-core body of C = A_sparse @ B.
//
// Replaces the TPU kernel `demm_spmm_pallas` (body `_spmm_kernel`) of the JAX
// package's kernels/demm_spmm.py for a bfloat16 B of many columns.  That
// kernel keeps one (M, block_c) tile of B on chip per step of its sequential
// group axis, expands the rows' packed {value, index} pairs into the scatter
// tile S (rows, M) and runs one MXU dot per group into a float32 accumulator.
// This body is the same shape on Hopper:
//
//   * a thread block owns a tile of BM = 64 x WGS rows and BN (128 or 256)
//     columns of C and walks the G groups in order (the TPU grid's
//     sequential axis); the float32 accumulator stays in registers, one
//     consumer warpgroup per 64 rows, across the whole walk;
//   * a producer warpgroup keeps a ring of `stages` stages in flight; a
//     stage holds `ng` consecutive groups (K rows ng x M, at most 256).  Per
//     stage it asks the TMA for the groups' K x BN tile of B (2-D tensor map,
//     128-byte swizzle, BN/64 boxes of 64 columns) and writes the scatter
//     tile S (BM x K, bf16) from the tile rows' pairs: each non-zero slot's
//     value rounded to bf16 at its column (with one warpgroup of rows, two
//     threads share a row).  A weight that may hold duplicate indices
//     (`fold`) has one thread per row sum the slots that share an index in
//     bf16 in slot order first (the `scatter_groups` rule) and store each
//     column once; that search doubled the time of this step on the H100,
//     so a weight known to hold none skips it;
//   * the pairs come through the TMA too, a ring of kTcPairSlots stages
//     ahead: values and indices are (R, G x Ne) row-major, so a stage's pairs
//     for the tile's rows are one 2-D box each (its first column rounded down
//     to 16 bytes: a box that starts elsewhere never completed on the H100,
//     so the box is wider and read at an offset).  The producer threads issue
//     no global load of their own;
//   * the consumers issue K/16 `wgmma.mma_async` m64nBNk16 per stage, A = S
//     (K-major, 32-byte swizzle) and B = the tile (N-major, transpose flag set),
//     both from shared memory, and release the stage once the next stage's
//     products are issued;
//   * the epilogue writes C in float32 through its strides (float2 stores
//     when C's rows are contiguous), masking ragged rows and columns.
//
// M need not be a multiple of 16 (then ng = 1 and K = Mpad, M rounded up):
// the last k-step's extra columns of S and rows of the B tile are zeros the
// kernel writes once (the TMA box is M rows), never the next group's rows --
// those would be out of bounds at the last group, and 0 x inf would give NaN
// where the gather body gives a number.  With ng > 1 (M a multiple of 16) a
// last stage of fewer groups reads rows past K, which the TMA fills with
// zeros.
//
// Bound on an H100: the tile product does the dense count of operations,
// 2 x R x K x Cd (3.4 GFLOP for 2560 x 2560 x 256, 3.4 us at the bf16 peak),
// against a byte bound of about 2 us for the packed pairs, B and C; so this
// body's floor is the tensor cores.  Measured, it runs far above that floor,
// and not on the tensor cores: without its wgmma it is barely faster, without
// writing S four times faster -- the producer's placing of the pairs, once
// per stage and column tile, is the limit (PERF.md).
//
// Every index and size below that does not touch wgmma, TMA or an mbarrier
// is a __host__ __device__ helper, so a CPU build of the header can check it.

#pragma once

#include <cuda_bf16.h>

#include "demm_xwt_common.cuh"
#include "hopper_async.cuh"

namespace demm {

constexpr int kTcMaxNe = 8;       // pairs per (row, group) a producer thread places
constexpr int kTcMaxM = 128;      // group width; wider groups leave too few stages
constexpr int kTcMaxK = 256;      // K rows per stage: the TMA box height limit
constexpr int kTcPairSlots = 4;   // stages of pairs in flight
constexpr int kTcMaxGroups = 3;   // groups per stage the launcher picks at most

struct SpmmTcGeom {
  int r, cd, groups, m, ne;
  int ng;         // groups per stage
  int kst;        // K rows of a stage: ng x M, or M rounded up to 16 when ng == 1
  int stages;
  int vbox, ibox; // columns of a stage's pair boxes (tc_pair_cols)
  long long s_cr, s_cc;   // element strides of C
  int vec_c;              // C rows contiguous and 8-byte aligned: float2 stores
  int v_bf16;             // packed values are bfloat16 (else float32)
  int fold;               // some group may hold two non-zero slots at one index
};

__host__ __device__ inline int tc_mpad(int m) { return (m + 15) / 16 * 16; }

// K rows of a stage of `ng` groups (ng > 1 only when M is a multiple of 16).
__host__ __device__ inline int tc_kst(int m, int ng) { return ng == 1 ? tc_mpad(m) : ng * m; }

// One stage: the B tile (BN/64 boxes of kst rows x 128 bytes) and S.
__host__ __device__ inline int tc_b_stage_bytes(int bn, int kst) {
  return (bn / 64) * kst * 128;
}
__host__ __device__ inline int tc_s_stage_bytes(int wgs, int kst) {
  return 64 * wgs * kst * 2;
}

// Columns of a box of `n` pairs of `elem` bytes whose first column is
// rounded down to 16 bytes: room for the offset, rounded up to 16 bytes.
__host__ __device__ inline int tc_pair_cols(int n, int elem) {
  const int per16 = 16 / elem;
  return (n + 2 * per16 - 2) / per16 * per16;
}

// First column of the box that holds pair column `col`, and the offset of
// `col` in it.
__host__ __device__ inline int tc_pair_box_start(int col, int elem) {
  return col / (16 / elem) * (16 / elem);
}

// One slot of the pair ring: the tile rows' values and indices of a stage.
__host__ __device__ inline int tc_pair_slot_bytes(int wgs, int ng, int ne, int vbytes) {
  return 64 * wgs * (tc_pair_cols(ng * ne, vbytes) * vbytes + tc_pair_cols(ng * ne, 4) * 4);
}

// Dynamic shared memory of a launch: 1024 bytes of alignment slack, the
// stages, the pair ring, and a full and an empty barrier per stage and one
// per pair slot.
__host__ __device__ inline size_t tc_smem_bytes(int bn, int wgs, int kst, int stages, int ng,
                                                int ne, int vbytes) {
  return 1024 +
         static_cast<size_t>(stages) * (tc_b_stage_bytes(bn, kst) + tc_s_stage_bytes(wgs, kst)) +
         static_cast<size_t>(kTcPairSlots) * tc_pair_slot_bytes(wgs, ng, ne, vbytes) +
         static_cast<size_t>(2 * stages + kTcPairSlots) * 8;
}

// Groups per stage when the caller leaves the choice open: 1 when M is not a
// multiple of 16, or when the 64 x 128 tile leaves more tiles than SMs (one
// group per stage lets two thread blocks share an SM); else the most, up to
// kTcMaxGroups, whose K rows stay within the TMA box (256) while `stages`
// stages (2 when that is left open too) still fit a block's shared memory.
// (The fastest at all three stablelm_3b shapes, Cd = 256, on the H100:
// chip_smoke.py --sweep.)
inline int tc_auto_groups(int m, int groups, int ne, int vbytes, int bn, int wgs, int stages,
                          int smem_limit, long long tiles, int sm_count) {
  if (m % 16 != 0 || (bn == 128 && wgs == 1 && tiles > sm_count)) return 1;
  const int want = stages > 0 ? stages : 2;
  int ng = 1;
  while (ng < groups && ng < kTcMaxGroups && (ng + 1) * m <= kTcMaxK &&
         tc_pair_cols((ng + 1) * ne, 2) <= 256 &&
         tc_smem_bytes(bn, wgs, (ng + 1) * m, want, ng + 1, ne, vbytes) <=
             static_cast<size_t>(smem_limit))
    ++ng;
  return ng;
}

// Byte offset of S[row][col] in a scatter tile of `rows` rows: one block of
// rows x 32 bytes per k-step of 16 columns, each row's two 16-byte halves
// swapped in rows 4-7 of every 8 (the 32-byte swizzle wgmma reads a K-major
// operand with), so the descriptor's stride offset (next 8 rows) is 256
// bytes and a k-step starts rows x 32 bytes further on.
__host__ __device__ inline int tc_s_offset(int row, int col, int rows) {
  return ((col >> 4) * rows + row) * 32 + ((((col >> 3) & 1) ^ ((row >> 2) & 1)) << 4) +
         (col & 7) * 2;
}

// Stages when the caller leaves the choice open: the most of 4, 3, 2 that fit
// a block's shared memory; for the 64 x 128 tile (registers for two thread
// blocks per SM), the most that still let two of them share an SM.  0: not
// even two stages fit.
inline int tc_auto_stages(int bn, int wgs, int kst, int ng, int ne, int vbytes, int smem_limit,
                          int smem_per_sm) {
  int fallback = 0;
  for (int s = 4; s >= 2; --s) {
    const size_t need = tc_smem_bytes(bn, wgs, kst, s, ng, ne, vbytes);
    if (need > static_cast<size_t>(smem_limit)) continue;
    if (fallback == 0) fallback = s;
    if (wgs == 2 || bn == 256 || 2 * (need + 1024) <= static_cast<size_t>(smem_per_sm))
      return s;
  }
  return fallback;
}

// Tile when the caller leaves the choice open: the largest of 128 x 256,
// 128 x 128, 64 x 256, 64 x 128 that still gives every SM a thread block,
// else the smallest.  The launch is one pass of the group walk per tile, so
// an idle SM costs its whole share.
inline void tc_auto_tile(int r, int cd, int sm_count, int* bn, int* wgs) {
  const int cand[4][2] = {{256, 2}, {128, 2}, {256, 1}, {128, 1}};
  for (const auto& t : cand) {
    const long long tiles = static_cast<long long>((r + 64 * t[1] - 1) / (64 * t[1])) *
                            ((cd + t[0] - 1) / t[0]);
    if (tiles >= sm_count) {
      *bn = t[0];
      *wgs = t[1];
      return;
    }
  }
  *bn = 128;
  *wgs = 1;
}

template <int BN, int WGS>
__global__ void __launch_bounds__(128 * (WGS + 1), WGS == 1 && BN == 128 ? 2 : 1)
spmm_tc_kernel(const __grid_constant__ CUtensorMap b_map, const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap i_map, float* __restrict__ c, SpmmTcGeom geo) {
  using namespace hopper;
  constexpr int BM = 64 * WGS;
  constexpr int ACC = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int b_bytes = tc_b_stage_bytes(BN, geo.kst);
  const int s_bytes = tc_s_stage_bytes(WGS, geo.kst);
  unsigned char* b_tiles = base;                                    // [stages][BN/64][kst][128 B]
  unsigned char* s_tiles = base + geo.stages * b_bytes;             // [stages][S]
  const int vbytes = geo.v_bf16 ? 2 : 4;
  const int pv_bytes = BM * geo.vbox * vbytes;
  const int p_bytes = pv_bytes + BM * geo.ibox * 4;
  unsigned char* p_slots = s_tiles + geo.stages * s_bytes;          // [slots][values | indices]
  uint64_t* full = reinterpret_cast<uint64_t*>(p_slots + kTcPairSlots * p_bytes);
  uint64_t* empty = full + geo.stages;
  uint64_t* pfull = empty + geo.stages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int r0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int box_rows = geo.ng == 1 ? geo.m : geo.kst;   // TMA box height

  if (tid == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(&full[s], 1 + 128);      // the TMA's expect_tx + every producer thread
      mbar_init(&empty[s], 128 * WGS);   // every consumer thread
    }
    for (int s = 0; s < kTcPairSlots; ++s) mbar_init(&pfull[s], 1);
    mbar_init_fence();
  }
  // Rows box_rows..kst-1 of every B tile (M rounded up to 16): zeros,
  // written once (the TMA box never touches them).
  if (geo.kst > box_rows) {
    const int pad16 = (geo.kst - box_rows) * 128 / 16;   // 16-byte units per box
    const int boxes = geo.stages * (BN / 64);
    for (int i = tid; i < boxes * pad16; i += blockDim.x) {
      const int box = i / pad16;
      const int off = i - box * pad16;
      *reinterpret_cast<uint4*>(b_tiles + static_cast<size_t>(box) * geo.kst * 128 +
                                box_rows * 128 + off * 16) = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  const int ksteps = geo.kst / 16;
  const int nstages = (geo.groups + geo.ng - 1) / geo.ng;   // stages of the walk
  if (wg == WGS) {
    // ---- producer warpgroup: B tiles through the TMA, S from the pairs ----
    const int pt = tid - 128 * WGS;
    const uint32_t b_tx = static_cast<uint32_t>((BN / 64) * box_rows * 128);
    // Pairs of stage t into slot t % kTcPairSlots (one thread).
    auto issue_pairs = [&](int t) {
      unsigned char* slot = p_slots + (t % kTcPairSlots) * p_bytes;
      uint64_t* bar = &pfull[t % kTcPairSlots];
      const int col = t * geo.ng * geo.ne;
      mbar_arrive_expect_tx(bar, static_cast<uint32_t>(p_bytes));
      tma_load_2d(slot, &v_map, tc_pair_box_start(col, vbytes), r0, bar);
      tma_load_2d(slot + pv_bytes, &i_map, tc_pair_box_start(col, 4), r0, bar);
    };
    if (pt == 0)
      for (int t = 0; t < kTcPairSlots && t < nstages; ++t) issue_pairs(t);

    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < nstages; ++t) {
      mbar_wait(&empty[stage], phase ^ 1);
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[stage], b_tx);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(b_tiles + static_cast<size_t>(stage) * b_bytes + j * geo.kst * 128,
                      &b_map, c0 + 64 * j, t * geo.ng * geo.m, &full[stage]);
      }
      unsigned char* st = s_tiles + static_cast<size_t>(stage) * s_bytes;
      for (int i = pt; i < s_bytes / 16; i += 128)
        reinterpret_cast<uint4*>(st)[i] = make_uint4(0, 0, 0, 0);
      named_bar_sync(1, 128);   // S is clear; every thread is done with stage t - 1's pairs
      if (pt == 0 && t >= 1 && t - 1 + kTcPairSlots < nstages) issue_pairs(t - 1 + kTcPairSlots);
      const unsigned char* slot = p_slots + (t % kTcPairSlots) * p_bytes;
      mbar_wait(&pfull[t % kTcPairSlots], (t / kTcPairSlots) & 1);
      // rows: thread pt % BM; with one warpgroup of rows, threads pt and
      // pt + 64 share a row and take alternate slots (or, with fold, pt alone)
      const int row = pt % BM;
      const int half = pt / BM;
      const int step = geo.fold ? 1 : 128 / BM;
      if (r0 + row < geo.r && (half == 0 || !geo.fold)) {
        const int ngt = min(geo.ng, geo.groups - t * geo.ng);
        const int col = t * geo.ng * geo.ne;
        const int voff = row * geo.vbox + col - tc_pair_box_start(col, vbytes);
        const float* vf = reinterpret_cast<const float*>(slot) + voff;
        const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(slot) + voff;
        const int32_t* ir = reinterpret_cast<const int32_t*>(slot + pv_bytes) + row * geo.ibox +
                            col - tc_pair_box_start(col, 4);
        if (!geo.fold) {
          for (int gl = 0; gl < ngt; ++gl) {
            for (int n = half; n < geo.ne; n += step) {
              const int at = gl * geo.ne + n;
              const float v = geo.v_bf16 ? __bfloat162float(vh[at]) : vf[at];
              const int ix = ir[at];
              if (v != 0.f && static_cast<unsigned>(ix) < static_cast<unsigned>(geo.m))
                *reinterpret_cast<__nv_bfloat16*>(st + tc_s_offset(row, gl * geo.m + ix, BM)) =
                    __float2bfloat16_rn(v);
            }
          }
        } else {
          for (int gl = 0; gl < ngt; ++gl) {
            float v[kTcMaxNe];
            int ix[kTcMaxNe];
#pragma unroll
            for (int n = 0; n < kTcMaxNe; ++n) {
              const int at = gl * geo.ne + n;
              v[n] = n < geo.ne ? (geo.v_bf16 ? __bfloat162float(vh[at]) : vf[at]) : 0.f;
              ix[n] = n < geo.ne ? ir[at] : -1;
            }
            // each column once, slots that share it summed in bf16 in slot
            // order first (scatter_groups)
#pragma unroll
            for (int n = 0; n < kTcMaxNe; ++n) {
              if (n >= geo.ne || static_cast<unsigned>(ix[n]) >= static_cast<unsigned>(geo.m))
                continue;
              bool first = true;
#pragma unroll
              for (int j = 0; j < n; ++j) first = first && ix[j] != ix[n];
              if (!first) continue;
              float w = __bfloat162float(__float2bfloat16_rn(v[n]));
#pragma unroll
              for (int j = n + 1; j < kTcMaxNe; ++j)
                if (j < geo.ne && ix[j] == ix[n])
                  w = __bfloat162float(
                      __float2bfloat16_rn(w + __bfloat162float(__float2bfloat16_rn(v[j]))));
              *reinterpret_cast<__nv_bfloat16*>(st + tc_s_offset(row, gl * geo.m + ix[n], BM)) =
                  __float2bfloat16_rn(w);
            }
          }
        }
      }
      fence_proxy_async();
      mbar_arrive(&full[stage]);
      if (++stage == geo.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each, wgmma over the group walk ----
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    const uint32_t a_base = smem_addr(s_tiles) + wg * 64 * 32;   // this warpgroup's 64 rows
    const uint32_t b_base = smem_addr(b_tiles);
    const uint32_t b_lbo = geo.kst * 128;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int g = 0; g < nstages; ++g) {
      mbar_wait(&full[stage], phase);
      fence_operands(acc);
      wgmma_fence();
      for (int ks = 0; ks < ksteps; ++ks) {
        const uint64_t da = wgmma_desc(a_base + stage * s_bytes + ks * BM * 32, 16, 256, 3);
        const uint64_t db = wgmma_desc(b_base + stage * b_bytes + ks * 16 * 128, b_lbo, 1024, 1);
        Wgmma<BN>::mma(acc, da, db);
      }
      wgmma_commit();
      fence_operands(acc);
      wgmma_wait<1>();                      // the previous stage's products are done
      if (g > 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == geo.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);

    // accumulator fragment of m64nBN: register 4j + 2h + e holds row
    // 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
    const int lane = tid & 31;
    const int row0 = r0 + wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= geo.r || col >= geo.cd) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        float* dst = c + static_cast<long long>(row) * geo.s_cr;
        if (geo.vec_c && col + 1 < geo.cd) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
        } else {
          dst[static_cast<long long>(col) * geo.s_cc] = v0;
          if (col + 1 < geo.cd) dst[static_cast<long long>(col + 1) * geo.s_cc] = v1;
        }
      }
    }
  }
}

}  // namespace demm
