// Shared pieces of the pairwise tile-sweep kernels.
//
// Layout (the same as the JAX package's Pallas kernels): coordinates are
// (D, N_pad) float32, frame axis contiguous, pads at 3e38. A sweep visits
// a flat list of (ti, tj) tiles of row_block x col_block frames; one CTA
// takes one tile entry. In the one-row-per-thread kernels (the first part
// of this file) thread t holds row ti*row_block + t, with its D
// coordinates in registers when D is a compile-time constant, and columns
// are staged through shared memory in chunks of CHUNK frames. The
// register micro-tiles of the second part serve the eight tile-sweep
// kernels.
//
// Distance arithmetic is the plain fma chain from zero, in ascending
// dimension order: diff = x - y; acc = fma(diff, diff, acc). It is
// bit-equal to the Pallas kernels run in interpret mode and to the port's
// plain PyTorch versions (torch.addcmul).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

namespace ck {

// columns staged per shared-memory chunk: with a compile-time D the chunk
// holds D * 256 floats (16 KB at D = 16); with a runtime D (D > 16) 32
// columns per chunk keep the staging area small for any D
constexpr int CHUNK_T = 256;
constexpr int CHUNK_R = 32;
constexpr int MAX_DT = 16;

template <int DT>
struct Chunk {
  static constexpr int value = DT > 0 ? CHUNK_T : CHUNK_R;
};

// Row coordinates: registers for a compile-time D, global reads (through
// L1) for the runtime-D fallback.
template <int DT>
struct RowCoords {
  float v[DT];
  __device__ __forceinline__ void load(const float* __restrict__ ct,
                                       int64_t n_pad, int64_t row, int) {
#pragma unroll
    for (int k = 0; k < DT; ++k) v[k] = ct[(int64_t)k * n_pad + row];
  }
  // squared distance to staged column c of a chunk of width ch
  __device__ __forceinline__ float dist2(const float* ys, int ch, int c,
                                         int) const {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < DT; ++k) {
      float diff = v[k] - ys[k * ch + c];
      acc = __fmaf_rn(diff, diff, acc);
    }
    return acc;
  }
};

template <>
struct RowCoords<0> {
  const float* base;
  int64_t n_pad;
  __device__ __forceinline__ void load(const float* __restrict__ ct,
                                       int64_t n_pad_, int64_t row, int) {
    base = ct + row;
    n_pad = n_pad_;
  }
  __device__ __forceinline__ float dist2(const float* ys, int ch, int c,
                                         int d) const {
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) {
      float diff = base[(int64_t)k * n_pad] - ys[k * ch + c];
      acc = __fmaf_rn(diff, diff, acc);
    }
    return acc;
  }
};

// Stage columns [col0, col0 + ch) of the (D, N_pad) matrix into ys
// (k-major, stride ch). All threads of the CTA take part.
__device__ __forceinline__ void stage_cols(float* ys,
                                           const float* __restrict__ ct,
                                           int64_t n_pad, int d,
                                           int64_t col0, int ch) {
  for (int e = threadIdx.x; e < d * ch; e += blockDim.x) {
    int k = e / ch;
    int c = e - k * ch;
    ys[e] = ct[(int64_t)k * n_pad + col0 + c];
  }
}

// Threads per CTA: one per tile row, rounded up to whole warps.
inline int cta_threads(int row_block) { return ((row_block + 31) / 32) * 32; }

inline size_t col_smem_bytes(int dt, int d) {
  return (size_t)(dt > 0 ? CHUNK_T : CHUNK_R) * (size_t)d * sizeof(float);
}

}  // namespace ck

// -- register micro-tiles ----------------------------------------------------
//
// A CTA of TR x MT_TC threads sweeps a tile in row passes of TR * MT_RM
// rows. Thread (tr, tc) owns the MT_RM rows p0 + tr + TR * m in registers
// for the whole pass and, in each step, the MT_RN contiguous staged
// columns cbase + MT_RN * tc + n: MT_RM * MT_RN independent fma chains per
// step.
// Columns are staged MT_CH<DT> at a time through two shared buffers that
// cp.async fills one chunk ahead. Rows and columns outside the sweep are
// staged as NaN, so their d2 is NaN and fails every compare: the inner
// loop has no bounds tests.
namespace ck {

constexpr int MT_RM = 4;
constexpr int MT_RN = 4;
constexpr int MT_TC = 8;
constexpr int MT_STEP = MT_TC * MT_RN;  // columns per step
constexpr int MT_MAX_TR = 32;           // 256 threads, 128 rows a pass

template <int DT>
struct MtChunk {
  static constexpr int value = DT > 0 ? 512 : MT_STEP;
};

// thread rows for a row block: enough for one pass, at most MT_MAX_TR
inline int mt_thread_rows(int row_block) {
  const int tr = (row_block + MT_RM - 1) / MT_RM;
  return tr < MT_MAX_TR ? tr : MT_MAX_TR;
}

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of columns [col0, col0 + CH) of the (D, N_pad) matrix
// into ys (k-major, stride CH); columns at or past ch or n_limit get NaN.
template <int CH>
__device__ __forceinline__ void mt_stage_cols(float* ys,
                                              const float* __restrict__ ct,
                                              int64_t n_pad, int d,
                                              int64_t col0, int ch,
                                              int64_t n_limit) {
  for (int e = threadIdx.x; e < d * CH; e += blockDim.x) {
    const int k = e / CH;
    const int c = e - k * CH;
    if (c < ch && col0 + c < n_limit)
      cp_async4(&ys[e], &ct[(int64_t)k * n_pad + col0 + c]);
    else
      ys[e] = qnan();
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// mt_stage_cols by 16-byte copies: four columns of one dimension per copy
// where the source is 16-byte aligned and all four lie inside the chunk
// and below n_limit; the other groups are loaded element by element,
// `fill` outside (NaN unless given; int32 rows go through as their bits).
// A thread issues d * CH / 4 / blockDim copies per chunk with little index
// arithmetic; the 4-byte copies of mt_stage_cols spend dozens of
// instructions on each column.
template <int CH>
__device__ __forceinline__ void mt_stage_cols16(float* ys,
                                                const float* __restrict__ ct,
                                                int64_t n_pad, int d,
                                                int64_t col0, int ch,
                                                int64_t n_limit,
                                                float fill = qnan()) {
  constexpr int G = CH / 4;  // groups of four columns per dimension
  const int nv = (int)max((int64_t)0, min((int64_t)ch, n_limit - col0));
  const bool aligned = (((uintptr_t)ct | (uintptr_t)(col0 * 4) |
                         (uintptr_t)(n_pad * 4)) & 15) == 0;
  for (int e = threadIdx.x; e < d * G; e += blockDim.x) {
    const int k = e / G;
    const int c = (e - k * G) * 4;
    float* dst = ys + k * CH + c;
    const float* src = ct + (int64_t)k * n_pad + col0 + c;
    if (aligned && c + 4 <= nv) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[u] = c + u < nv ? src[u] : fill;
    }
  }
}

// A pass's row coordinates: registers for a compile-time D; for the
// runtime-D instance, pointers read through L1 in the inner loop.
template <int DT>
struct MtRows {
  float v[MT_RM][DT];
  __device__ __forceinline__ void load(const float* __restrict__ ct,
                                       int64_t n_pad, int,
                                       const int64_t (&row)[MT_RM],
                                       const bool (&ok)[MT_RM]) {
#pragma unroll
    for (int m = 0; m < MT_RM; ++m)
#pragma unroll
      for (int k = 0; k < DT; ++k)
        v[m][k] = ok[m] ? ct[(int64_t)k * n_pad + row[m]] : qnan();
  }
  __device__ __forceinline__ float get(int m, int k) const {
    return v[m][k];
  }
};

template <>
struct MtRows<0> {
  const float* p[MT_RM];
  int64_t n_pad;
  __device__ __forceinline__ void load(const float* __restrict__ ct,
                                       int64_t n_pad_, int,
                                       const int64_t (&row)[MT_RM],
                                       const bool (&ok)[MT_RM]) {
    n_pad = n_pad_;
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) p[m] = ok[m] ? ct + row[m] : nullptr;
  }
  __device__ __forceinline__ float get(int m, int k) const {
    return p[m] ? p[m][(int64_t)k * n_pad] : qnan();
  }
};

// d2[m][n] between the pass rows and the step's MT_RN contiguous columns
// c0 .. c0 + MT_RN - 1 of a staged chunk (c0 a multiple of MT_RN: one
// 16-byte shared load per dimension), each the fma chain from zero in
// ascending dimension order.
template <int DT, int CH>
__device__ __forceinline__ void mt_dist2(const MtRows<DT>& x,
                                         const float* ys, int d, int c0,
                                         float (&d2)[MT_RM][MT_RN]) {
  static_assert(MT_RN == 4, "one float4 of columns per dimension");
#pragma unroll
  for (int m = 0; m < MT_RM; ++m)
#pragma unroll
    for (int n = 0; n < MT_RN; ++n) d2[m][n] = 0.0f;
  const int dd = DT > 0 ? DT : d;
#pragma unroll
  for (int k = 0; k < dd; ++k) {
    const float4 y4 = *reinterpret_cast<const float4*>(&ys[k * CH + c0]);
    const float y[MT_RN] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const float xm = x.get(m, k);
#pragma unroll
      for (int n = 0; n < MT_RN; ++n) {
        const float diff = xm - y[n];
        d2[m][n] = __fmaf_rn(diff, diff, d2[m][n]);
      }
    }
  }
}

// shuffle mask of the CTA's (possibly partial) warp
__device__ __forceinline__ unsigned mt_warp_mask() {
  const int base = threadIdx.x & ~31;
  const int live = (int)blockDim.x - base;
  return live >= 32 ? FULL_MASK : ((1u << live) - 1u);
}

// -- counting on the micro-tiles (pops_bidir, pops_tiles) --------------------

constexpr int MAX_RADII = 8;  // radii per launch; the wrappers group more

// Threads of a counting CTA: whole warps (the thread rows rounded up to
// four), so a warp's four thread rows reduce their column counts by
// shuffles with the full mask; the extra rows are outside the tile.
inline int mt_count_threads(int row_block) {
  return (mt_thread_rows(row_block) + 3) / 4 * 4 * MT_TC;
}

// CTAs per SM that __launch_bounds__ asks of a counting kernel: three
// (80 registers) while the rows' coordinates and the two counters per row
// and radius fit without spills (D = 4 with one or two radii), two
// (128) above, one for the largest D with eight radii. ptxas reports
// spills of up to ~60 bytes for some of the two-CTA instances.
constexpr int mt_count_ctas(int dt, int nr) {
  return (dt > 0 ? dt : 2) + 2 * nr <= 8 ? 3
         : (dt > 0 ? dt : 2) + 2 * nr <= 24 ? 2 : 1;
}

// The radii of one launch, set up per CTA so that ONE saturating fma per
// pair and radius gives w = (d2 <= r2) as exactly 1.0f or 0.0f for every
// d2 >= 0, inf or NaN (the compare as FSETP + SEL costs the integer pipe,
// at half the FP32 rate, two instructions):
//     w = sat(fma(d2, -sc, of)).
//  - 2^-100 <= r2 < FLT_MAX: rp = nextafter(r2, inf), so d2 <= r2 iff
//    d2 < rp; sc = 2^(26 - e), e the exponent of rp; of = rp * sc (exact).
//    If d2 < rp the gap rp - d2 is at least 2^(e - 24) (exact by Sterbenz
//    for d2 >= rp / 2, else above rp / 2), so the fma's one rounding of
//    sc * (rp - d2) is >= 4 and sat gives 1. If d2 >= rp it is <= 0, and
//    never -0 since of > 0; an overflowing d2 * sc gives -inf. sat gives 0
//    for these and for NaN.
//  - r2 = FLT_MAX (rp = inf): sc = 2^-126, of = 8; every finite d2 gives
//    more than 4, inf gives -inf.
//  - r2 = inf: sc = -2^-126, of = 1; every d2 gives at least 1, inf inf.
//  - r2 < 0 or NaN (a radius the tile's rmask turns off): sc = of = 0;
//    d2 * -0 + 0 is +0, or NaN for d2 = inf.
//  - 0 <= r2 < 2^-100 (r = 0 among them): sc would overflow, so `exact`
//    is set and the CTA compares d2 <= r2 instead.
template <int NR>
struct CountRadii {
  float r2[NR], sc[NR], of[NR];
  bool exact;

  // radius r is on where r < n_radii and bit r of `on` is set
  __device__ __forceinline__ void setup(const float* __restrict__ radii2,
                                       int n_radii, unsigned on) {
    exact = false;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float v =
          (r < n_radii && ((on >> r) & 1u)) ? radii2[r] : -1.0f;
      const float rp = nextafterf(v, INFINITY);
      const int e = ((__float_as_int(rp) >> 23) & 0xff) - 127;
      r2[r] = v;
      sc[r] = of[r] = 0.0f;  // r2 < 0 or NaN
      if (v >= 0.0f) {
        if (isinf(v)) {
          sc[r] = -0x1p-126f;
          of[r] = 1.0f;
        } else if (isinf(rp)) {
          sc[r] = 0x1p-126f;
          of[r] = 8.0f;
        } else if (e >= -100) {
          sc[r] = __int_as_float((153 - e) << 23);
          of[r] = rp * sc[r];
        } else {
          exact = true;
        }
      }
    }
  }

  // w = (d2 <= r2[r]) as 1.0f or 0.0f
  template <bool EXACT>
  __device__ __forceinline__ float w(int r, float d2) const {
    if (EXACT) return d2 <= r2[r] ? 1.0f : 0.0f;
    return __saturatef(__fmaf_rn(d2, -sc[r], of[r]));
  }
};

// Counts of w summed as float bits: k ones add up to k * bits(1.0f) =
// k * 127 * 2^23 mod 2^32, so bits 23..31 hold 127 k mod 512 and
// 383 = 127^-1 mod 512 recovers k < 512. One IADD3 adds two w's.
__device__ __forceinline__ int decode_ones(unsigned acc) {
  return (int)(((acc >> 23) * 383u) & 511u);
}

// The passes of one kept cell or tile of a row-side counting kernel
// (pops_tiles, pops_sparse): its rows against the chunks of its columns
// below n_valid, every pair with d2 <= r^2 of an on radius adding 1 to
// the row's count. ys holds two chunks.
template <int DT, int NR, bool EXACT>
__device__ __forceinline__ void count_cell(
    const CountRadii<NR>& rad, float* ys,
    const float* __restrict__ rows_t, int64_t r_pad,
    const float* __restrict__ cols_t, int64_t n_pad, int d, int n_radii,
    int n_valid, int64_t row0, int64_t colbase, int row_block,
    int col_block, int* __restrict__ out) {
  constexpr int CH = MtChunk<DT>::value;
  const int tid = threadIdx.x;
  const int tc = tid % MT_TC;
  const int tr = tid / MT_TC;
  const int n_tr = blockDim.x / MT_TC;
  const int rows_per_pass = n_tr * MT_RM;
  const int n_chunks =
      (int)((min((int64_t)col_block, n_valid - colbase) + CH - 1) / CH);

  for (int p0 = 0; p0 < row_block; p0 += rows_per_pass) {
    int64_t row[MT_RM];
    bool ok[MT_RM];
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const int r = p0 + tr + n_tr * m;
      row[m] = row0 + r;
      ok[m] = r < row_block;
    }
    MtRows<DT> x;
    x.load(rows_t, r_pad, d, row, ok);
    int cnt[NR][MT_RM];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int m = 0; m < MT_RM; ++m) cnt[r][m] = 0;

    __syncthreads();  // the previous pass or cell is done with both buffers
    mt_stage_cols16<CH>(ys, cols_t, n_pad, d, colbase, min(CH, col_block),
                        n_valid);
    cp_async_commit();

    for (int q = 0; q < n_chunks; ++q) {
      const int b = q & 1;
      const int64_t col0 = colbase + (int64_t)q * CH;
      const int ch = min(CH, col_block - q * CH);
      const float* yb = ys + b * d * CH;
      cp_async_wait_all();
      __syncthreads();  // chunk q staged; chunk q - 1 computed
      if (q + 1 < n_chunks) {
        mt_stage_cols16<CH>(ys + (b ^ 1) * d * CH, cols_t, n_pad, d,
                            col0 + CH, min(CH, col_block - (q + 1) * CH),
                            n_valid);
        cp_async_commit();
      }
      // the chunk's ones per row as float bits: at most CH / MT_TC < 512
      unsigned ones[NR][MT_RM];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) ones[r][m] = 0u;
      for (int cbase = 0; cbase < ch; cbase += MT_STEP) {
        float d2[MT_RM][MT_RN];
        mt_dist2<DT, CH>(x, yb, d, cbase + MT_RN * tc, d2);
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int m = 0; m < MT_RM; ++m)
#pragma unroll
            for (int n = 0; n < MT_RN; ++n)
              ones[r][m] +=
                  __float_as_uint(rad.template w<EXACT>(r, d2[m][n]));
      }
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) cnt[r][m] += decode_ones(ones[r][m]);
    }

    // rows: fold across the MT_TC threads of each row
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int m = 0; m < MT_RM; ++m) {
        int c = cnt[r][m];
#pragma unroll
        for (int off = MT_TC / 2; off > 0; off >>= 1)
          c += __shfl_xor_sync(FULL_MASK, c, off);
        if (tc == 0 && ok[m] && r < n_radii && c != 0)
          atomicAdd(&out[(int64_t)r * r_pad + row[m]], c);
      }
    }
  }
}

// The exact compare for radii below 2^-100, in one runtime-D instance per
// radius bucket (its 32-column chunks fit every instance's buffers).
template <int NR>
__device__ __noinline__ void count_cell_exact(
    CountRadii<NR> rad, float* ys, const float* __restrict__ rows_t,
    int64_t r_pad, const float* __restrict__ cols_t, int64_t n_pad, int d,
    int n_radii, int n_valid, int64_t row0, int64_t colbase, int row_block,
    int col_block, int* __restrict__ out) {
  count_cell<0, NR, true>(rad, ys, rows_t, r_pad, cols_t, n_pad, d, n_radii,
                          n_valid, row0, colbase, row_block, col_block, out);
}

// -- nearest-neighbour keys on the micro-tiles (nn_bidir, nn_tiles, ----------
// -- nn_sparse) --------------------------------------------------------------
//
// A (d2, original id) minimum is the 64-bit key (float_bits(d2) << 32) | id
// (d2 >= 0 keeps the bit order equal to the lexicographic order, so
// atomicMin on it is exact in any order). Kernels compare keys shifted by
// 2^32, s = key - 2^32 (the d2 word minus one, as unsigned): d2 = 0 wraps
// to the top and never wins, so "d2 > 0" costs no test, and every held
// minimum starts at most at INF0 = (bits(inf) - 1) << 32, which an
// infinite or NaN d2 (pads, and NaN-staged frames) can never beat.

using u64 = unsigned long long;

constexpr u64 ONE_HI = 1ull << 32;
// shifted-domain "none": an infinite d2 with id 0, above every finite key
constexpr u64 INF0 = 0x7F7FFFFFull << 32;

// the shifted key of a buffer key, at most INF0
__device__ __forceinline__ u64 shift_key(u64 key) {
  const u64 s = key - ONE_HI;
  return s < INF0 ? s : INF0;
}

// the filter threshold of a frame's two held keys: nextafter(d2 of the
// larger, +inf), +inf for INF0; a pair with d2 - T >= 0 (or NaN) can
// lower neither key
__device__ __forceinline__ float filter_t(u64 nh, u64 hd) {
  const unsigned hi = (unsigned)((nh > hd ? nh : hd) >> 32);
  return __uint_as_float(min(hi + 2u, 0x7F800000u));
}

__device__ __forceinline__ u64 skey(float d2, int oid) {
  return ((u64)(__float_as_uint(d2) - 1u) << 32) | (unsigned)oid;
}

// minimum over the MT_TC threads of a row: (d2, id) keys, or labels
__device__ __forceinline__ u64 warp_min8(u64 v, unsigned mask) {
#pragma unroll
  for (int off = MT_TC / 2; off > 0; off >>= 1) {
    const u64 o = __shfl_xor_sync(mask, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ int warp_min8(int v, unsigned mask) {
#pragma unroll
  for (int off = MT_TC / 2; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(mask, v, off));
  return v;
}

// Start the copy of chunk columns [col0, col0 + ch) into buffer `buf`:
// coordinates, fe and original ids (the ids bit for bit through the float
// stager; a NaN-staged column's id is never read as a candidate's).
template <int CH>
__device__ __forceinline__ void nn_stage_chunk(
    float* ys, float* s_fe, int* s_oid, int buf,
    const float* __restrict__ cols_t, int64_t n_pad, int d,
    const float* __restrict__ fe_cols, const int* __restrict__ oid_cols,
    int64_t col0, int ch, int n_valid) {
  mt_stage_cols16<CH>(ys + buf * d * CH, cols_t, n_pad, d, col0, ch, n_valid);
  mt_stage_cols16<CH>(s_fe + buf * CH, fe_cols, n_pad, 1, col0, ch, n_valid);
  mt_stage_cols16<CH>(reinterpret_cast<float*>(s_oid + buf * CH),
                      reinterpret_cast<const float*>(oid_cols), n_pad, 1,
                      col0, ch, n_valid);
  cp_async_commit();
}

// Shared memory of an nn_cell CTA: two chunks of fe, ids and coordinates.
inline size_t nn_cell_smem_bytes(int ch, int d) {
  return (size_t)2 * ch * (sizeof(float) + sizeof(int) + d * sizeof(float));
}

// The passes of one kept cell or tile of a row-side NN kernel (nn_tiles,
// nn_sparse): its rows against the chunks of its columns below n_valid
// (colbase < n_valid), folding each row's (nh, hd) minima into the two
// key rows keys[slot] and keys[key_stride + slot]. The slot is the row
// position (BY_ID false) or the row's original id oid_rows[row] (BY_ID
// true); a row whose id is INT32_MAX is a pad and neither reads nor writes
// the buffer. Row keys start from the buffer at each pass start: a held
// key is never below the final minimum, so the filter stays exact in any
// CTA order, and a tile that runs after another tile of its rows starts
// from that tile's keys. smem holds two chunks (nn_cell_smem_bytes).
template <int DT, bool BY_ID>
__device__ __forceinline__ void nn_cell(
    float* smem, const float* __restrict__ rows_t, int64_t r_pad,
    const float* __restrict__ fe_rows, const int* __restrict__ oid_rows,
    const float* __restrict__ cols_t, int64_t n_pad, int d,
    const float* __restrict__ fe_cols, const int* __restrict__ oid_cols,
    int n_valid, int64_t row0, int64_t colbase, int row_block, int col_block,
    u64* __restrict__ keys, int64_t key_stride) {
  constexpr int CH = MtChunk<DT>::value;
  float* s_fe = smem;                                    // 2 x CH
  int* s_oid = reinterpret_cast<int*>(s_fe + 2 * CH);    // 2 x CH
  float* ys = reinterpret_cast<float*>(s_oid + 2 * CH);  // 2 x d * CH
  u64* keys_hd = keys + key_stride;

  const int tid = threadIdx.x;
  const int tc = tid % MT_TC;
  const int tr = tid / MT_TC;
  const int n_tr = blockDim.x / MT_TC;
  const int rows_per_pass = n_tr * MT_RM;
  const unsigned mask = mt_warp_mask();
  const int n_chunks =
      (int)((min((int64_t)col_block, n_valid - colbase) + CH - 1) / CH);

  for (int p0 = 0; p0 < row_block; p0 += rows_per_pass) {
    int64_t row[MT_RM], slot[MT_RM];
    bool ok[MT_RM];
    float fx[MT_RM];
    u64 rnh[MT_RM], rhd[MT_RM];
    float t_row[MT_RM];
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const int r = p0 + tr + n_tr * m;
      row[m] = row0 + r;
      ok[m] = r < row_block;
      slot[m] = row[m];
      if (BY_ID) {
        const int id = ok[m] ? oid_rows[row[m]] : 0x7fffffff;
        ok[m] = id != 0x7fffffff;
        slot[m] = id;
      }
      fx[m] = ok[m] ? fe_rows[row[m]] : qnan();
      rnh[m] = ok[m] ? shift_key(keys[slot[m]]) : INF0;
      rhd[m] = ok[m] ? shift_key(keys_hd[slot[m]]) : INF0;
      t_row[m] = filter_t(rnh[m], rhd[m]);
    }
    MtRows<DT> x;
    x.load(rows_t, r_pad, d, row, ok);

    __syncthreads();  // the previous pass or cell is done with both buffers
    nn_stage_chunk<CH>(ys, s_fe, s_oid, 0, cols_t, n_pad, d, fe_cols,
                       oid_cols, colbase, min(CH, col_block), n_valid);

    for (int q = 0; q < n_chunks; ++q) {
      const int b = q & 1;
      const int ch = min(CH, col_block - q * CH);
      const float* yb = ys + b * d * CH;
      const float* feb = s_fe + b * CH;
      const int* oidb = s_oid + b * CH;
      cp_async_wait_all();
      __syncthreads();  // chunk q staged; chunk q - 1 computed
      if (q + 1 < n_chunks)
        nn_stage_chunk<CH>(ys, s_fe, s_oid, b ^ 1, cols_t, n_pad, d, fe_cols,
                           oid_cols, colbase + (int64_t)(q + 1) * CH,
                           min(CH, col_block - (q + 1) * CH), n_valid);

      for (int cbase = 0; cbase < ch; cbase += MT_STEP) {
        const int c0 = cbase + MT_RN * tc;
        float d2[MT_RM][MT_RN];
        mt_dist2<DT, CH>(x, yb, d, c0, d2);
        // filter: the sign bit is set where d2 is below a row's threshold
        unsigned near[MT_RM];
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) {
          near[m] = 0;
#pragma unroll
          for (int n = 0; n < MT_RN; ++n)
            near[m] |= __float_as_uint(d2[m][n] - t_row[m]);
        }
        if ((int)(near[0] | near[1] | near[2] | near[3]) >= 0) continue;

        // exact updates, only for the rows the filter flagged
        const float4 fy4 = *reinterpret_cast<const float4*>(&feb[c0]);
        const float fy[MT_RN] = {fy4.x, fy4.y, fy4.z, fy4.w};
        const int4 oy4 = *reinterpret_cast<const int4*>(&oidb[c0]);
        const int oy[MT_RN] = {oy4.x, oy4.y, oy4.z, oy4.w};
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) {
          if ((int)near[m] >= 0) continue;
#pragma unroll
          for (int n = 0; n < MT_RN; ++n) {
            const u64 kr = skey(d2[m][n], oy[n]);
            rnh[m] = kr < rnh[m] ? kr : rnh[m];
            rhd[m] = (fy[n] < fx[m] && kr < rhd[m]) ? kr : rhd[m];
          }
          t_row[m] = filter_t(rnh[m], rhd[m]);
        }
      }
    }

    // rows: fold across the MT_TC threads of each row; an atomic only
    // where the row still improves the buffer
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const u64 nh = warp_min8(rnh[m], mask);
      const u64 hd = warp_min8(rhd[m], mask);
      if (tc == 0 && ok[m]) {
        if (nh < shift_key(keys[slot[m]]))
          atomicMin(&keys[slot[m]], nh + ONE_HI);
        if (hd < shift_key(keys_hd[slot[m]]))
          atomicMin(&keys_hd[slot[m]], hd + ONE_HI);
      }
    }
  }
}
}  // namespace ck

// Dispatch a counting kernel on the number of radii of one launch,
// rounded up to a bucket: 1, 2, 4 or 8 (the extra radii compare against
// -1 and count nothing).
#define CK_DISPATCH_NR(n, NR, ...)                              \
  if ((n) <= 1) { constexpr int NR = 1; __VA_ARGS__; }          \
  else if ((n) <= 2) { constexpr int NR = 2; __VA_ARGS__; }     \
  else if ((n) <= 4) { constexpr int NR = 4; __VA_ARGS__; }     \
  else { constexpr int NR = 8; __VA_ARGS__; }

// Dispatch a kernel template on D: a compile-time instance for
// 1 <= D <= 16, the runtime-D instance (DT = 0) above that.
#define CK_DISPATCH_D(d, DT, ...)         \
  switch (d) {                            \
    case 1: { constexpr int DT = 1; __VA_ARGS__; } break;   \
    case 2: { constexpr int DT = 2; __VA_ARGS__; } break;   \
    case 3: { constexpr int DT = 3; __VA_ARGS__; } break;   \
    case 4: { constexpr int DT = 4; __VA_ARGS__; } break;   \
    case 5: { constexpr int DT = 5; __VA_ARGS__; } break;   \
    case 6: { constexpr int DT = 6; __VA_ARGS__; } break;   \
    case 7: { constexpr int DT = 7; __VA_ARGS__; } break;   \
    case 8: { constexpr int DT = 8; __VA_ARGS__; } break;   \
    case 9: { constexpr int DT = 9; __VA_ARGS__; } break;   \
    case 10: { constexpr int DT = 10; __VA_ARGS__; } break; \
    case 11: { constexpr int DT = 11; __VA_ARGS__; } break; \
    case 12: { constexpr int DT = 12; __VA_ARGS__; } break; \
    case 13: { constexpr int DT = 13; __VA_ARGS__; } break; \
    case 14: { constexpr int DT = 14; __VA_ARGS__; } break; \
    case 15: { constexpr int DT = 15; __VA_ARGS__; } break; \
    case 16: { constexpr int DT = 16; __VA_ARGS__; } break; \
    default: { constexpr int DT = 0; __VA_ARGS__; } break;  \
  }
