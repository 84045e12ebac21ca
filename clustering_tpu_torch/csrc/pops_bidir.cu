// Bidirectional multi-radius population counts over an upper-triangular
// tile list.
//
// Replaces the TPU kernel clustering_tpu/ops/pallas_kernels.py:
// _pops_bidir_kernel (called through _pops_bidir_call /
// pops_tiles_bidir_all). Each strictly-upper pair row < col < n_valid of a
// listed tile with d2 <= r^2 adds 1 to both frames' counts at radius r;
// bit r of the tile's rmask gates radius r. Entries with tj < 0 or rmask 0
// do nothing. The diagonal +1 is added by the Python wrapper.
//
// What bounds it on the H100: the FP32 pipe, 3 * D flops per pair (D
// subtractions, D fmas), beside the count. The TPU kept the column counts
// of the whole sweep resident in VMEM; here CTAs run in any order, so the
// cross-tile sums are global atomics, kept rare. The design (register
// micro-tiles of common.cuh, as nn_bidir.cu):
//  - a thread holds MT_RM rows for the whole pass and evaluates
//    MT_RM x MT_RN pairs per step, 16 independent fma chains, columns read
//    as one float4 per dimension; the next 512-column chunk comes in by
//    16-byte cp.async into a second buffer while the current one is
//    computed;
//  - rows and columns at or past n_valid or outside the tile are staged as
//    NaN, so `d2 <= r^2` alone decides a count: one saturating fma per
//    pair and radius gives it as 1.0f or 0.0f, exactly (ck::CountRadii);
//    the kernel is instantiated for 1, 2, 4 or 8 radii, so the main path's
//    one radius costs one compare per pair. A radius below 2^-100 (r = 0)
//    takes the exact compare in a runtime-D instance;
//  - rmask is read once per tile: a radius whose bit is clear counts
//    nothing (ck::CountRadii);
//  - the strict col > row test runs only in steps that reach the pass's
//    rows (the diagonal tiles' few steps), where it sets d2 to NaN; steps
//    and chunks whose columns all lie at or left of the pass's first row
//    are skipped;
//  - row counts: the ones' float bits add two at a time in IADD3s,
//    decoded once per chunk (ck::decode_ones), then held in registers for
//    the pass, folded across the MT_TC threads of a row by shuffles, and
//    sent as one atomicAdd per row and radius where non-zero;
//  - column counts: no per-pair ballot or atomic. Each step a thread adds
//    its w's per column over its MT_RM rows onto 2^23 in float, so the low
//    byte of the float's bits is the count (at most 4), and packs the four
//    bytes into one word by byte permutes; two shuffles add the four
//    thread rows of the warp (fields at most 16) and one lane per column
//    group stores the word into the warp's slot of a per-chunk shared
//    array (a plain store: each slot has one writer). At the chunk's end
//    the CTA's warps' words are added (fields at most 8 * 16 = 128, below
//    256, so the packed sum is exact), and one global atomicAdd goes out
//    per non-zero column and radius. Against a shared atomic per column
//    per warp and step this spends one store per step and warp, and the
//    chunk's fold reads eight words per four columns;
//  - with several radii (the NR = 2, 4 and 8 instances) a warp skips, in
//    each step, every radius that none of the step's pairs reaches: one
//    min over the thread's d2's and one __reduce_min_sync give the warp's
//    least d2 (NaN, a pad or a pair not strictly upper, is far; every d2
//    is +0 or more, so its bits order as unsigned), one compare against
//    the largest radius passes over a step that counts nothing, and each
//    radius's body (its fmas, the row ones, the column packing, the
//    shuffles and the slot store) runs only where its own w of the least
//    is 1. A skipped radius has every d2 of the step above r^2 (or NaN),
//    where w is exactly 0, so the counts are those of the body; a radius
//    whose rmask bit is clear has w = 0 for every d2 and never runs. The
//    branches are warp-uniform, as the body's shuffles need. The column
//    slots start at 0 and the fold puts each word it reads back to 0, so
//    a skipped step stores nothing; the fold reads only the radii that
//    some warp of the CTA ran in the chunk (the warps' live bits in shared
//    memory). The row counts go at each chunk's end, for the radii the
//    warp ran, into shared counts of the pass by shared atomics, and from
//    there out at the pass's end: held in registers as with one radius,
//    they and the skip's few would spill at NR = 8. A scan's steps reach
//    ~1 of its 8 radii on average, so this removes most of the per-radius
//    work, which sets the pace there. With one radius the tile list is
//    that radius's own and most steps count something: the least would
//    cost more than it saves, so the NR = 1 instance keeps the plain
//    step;
//  - the NR > 1 instances count the warps' steps that computed distances
//    and the (step, radius) bodies that ran: per warp and chunk in one
//    register with its live bits, into shared sums at the chunk's end; a
//    CTA adds the two sums into slot blockIdx % 128 of the caller's
//    `steps` buffer by one two-lane 64-bit atomic (none where it is null).
// The distance is the fma chain from zero in ascending dimension order and
// the count is exactly `d2 <= r^2`, so the counts are the plain version's
// and the Pallas kernel's.

#include "common.cuh"

namespace {

// Step counts of a CTA: slots of the caller's buffer that the CTAs'
// atomics are spread over.
constexpr int STEP_SLOTS = 128;

// The passes of one listed tile. smem holds two column chunks, then the
// warps' column words (NR x warps x CH / MT_RN), then, with several
// radii, each warp's live radii of the chunk (warps words), the CTA's two
// step counts and the pass's row counts (NR x rows per pass).
template <int DT, int NR, bool EXACT>
__device__ __forceinline__ void count_tile(
    const ck::CountRadii<NR>& rad, float* smem,
    const float* __restrict__ ct, int64_t n_pad, int d, int n_radii,
    int n_valid, int64_t row0, int64_t colbase, int row_block,
    int col_block, int* __restrict__ out,
    unsigned long long* __restrict__ steps) {
  using namespace ck;
  constexpr int CH = MtChunk<DT>::value;
  constexpr int CW = CH / MT_RN;  // column words per warp and radius
  float* ys = smem;
  unsigned* s_colw = reinterpret_cast<unsigned*>(ys + 2 * d * CH);

  const int tid = threadIdx.x;
  const int tc = tid % MT_TC;
  const int tr = tid / MT_TC;
  const int n_tr = blockDim.x / MT_TC;
  const int rows_per_pass = n_tr * MT_RM;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool word_lane = (tid & 31) < MT_TC;  // the warp's first thread row
  const int n_chunks =
      (int)((min((int64_t)col_block, n_valid - colbase) + CH - 1) / CH);

  unsigned* s_live = s_colw + NR * n_warps * CW;
  unsigned* s_steps = s_live + n_warps;
  int* s_rcnt = reinterpret_cast<int*>(s_steps + 2);
  // the warp's chunk in one register: bits 0-7 the radii it ran, 8-15 its
  // steps that computed distances (at most CH / MT_STEP = 16), 16-31 the
  // radius bodies they ran (at most 128)
  unsigned tally = 0u;
  float r2max = -1.0f;  // the largest radius on (-1: none)
  if constexpr (NR > 1) {
#pragma unroll
    for (int r = 0; r < NR; ++r) r2max = fmaxf(r2max, rad.r2[r]);
    // the slots start at 0, visible after the first pass's __syncthreads
    uint4* colw4 = reinterpret_cast<uint4*>(s_colw);
    for (int e = tid; e < NR * n_warps * CW / 4; e += blockDim.x)
      colw4[e] = make_uint4(0u, 0u, 0u, 0u);
    if (tid == 0) s_steps[0] = s_steps[1] = 0u;
    for (int e = tid; e < NR * rows_per_pass; e += blockDim.x) s_rcnt[e] = 0;
  }

  for (int p0 = 0; p0 < row_block; p0 += rows_per_pass) {
    // rows at or past n_valid have no column right of them below n_valid
    const int64_t rmin = row0 + p0;
    if (rmin >= n_valid) break;
    const int64_t rmax =
        min(row0 + min(p0 + rows_per_pass, row_block), (int64_t)n_valid) - 1;
    // chunks whose every column lies at or left of rmin hold no
    // strictly-upper pair of this pass (nor of a later one)
    const int64_t right = rmin + 1 - colbase;  // first column right of rmin
    const int q0 = right > 0 ? (int)(right / CH) : 0;
    if (q0 >= n_chunks) break;

    int64_t row[MT_RM];
    bool ok[MT_RM];
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const int r = p0 + tr + n_tr * m;
      row[m] = row0 + r;
      ok[m] = r < row_block && row[m] < n_valid;
    }
    MtRows<DT> x;
    x.load(ct, n_pad, d, row, ok);
    int rcnt[NR][MT_RM];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int m = 0; m < MT_RM; ++m) rcnt[r][m] = 0;

    __syncthreads();  // the previous pass is done with every buffer
    mt_stage_cols16<CH>(ys, ct, n_pad, d, colbase + (int64_t)q0 * CH,
                        min(CH, col_block - q0 * CH), n_valid);
    cp_async_commit();

    for (int q = q0; q < n_chunks; ++q) {
      const int b = (q - q0) & 1;
      const int64_t col0 = colbase + (int64_t)q * CH;
      const int ch = min(CH, col_block - q * CH);
      const float* yb = ys + b * d * CH;
      cp_async_wait_all();
      __syncthreads();  // chunk q staged; chunk q - 1's words folded
      if (q + 1 < n_chunks) {
        mt_stage_cols16<CH>(ys + (b ^ 1) * d * CH, ct, n_pad, d, col0 + CH,
                            min(CH, col_block - (q + 1) * CH), n_valid);
        cp_async_commit();
      }

      // the chunk's ones per row as float bits: at most CH / MT_TC < 512
      unsigned ones[NR][MT_RM];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) ones[r][m] = 0u;
      for (int cbase = 0; cbase < ch; cbase += MT_STEP) {
        const int64_t cs = col0 + cbase;
        unsigned* slot = s_colw + warp * CW + cbase / MT_RN + tc;
        if (cs + MT_STEP - 1 <= rmin) {  // every column at or left of rmin
          if constexpr (NR == 1) {  // NR > 1: the slots are already 0
            if (word_lane) {
#pragma unroll
              for (int r = 0; r < NR; ++r) slot[r * n_warps * CW] = 0u;
            }
          }
          continue;
        }
        const int c0 = cbase + MT_RN * tc;
        float d2[MT_RM][MT_RN];
        mt_dist2<DT, CH>(x, yb, d, c0, d2);
        if (cs <= rmax) {  // the step reaches the pass's rows
#pragma unroll
          for (int m = 0; m < MT_RM; ++m)
#pragma unroll
            for (int n = 0; n < MT_RN; ++n)
              if (col0 + c0 + n <= row[m]) d2[m][n] = qnan();
        }
        float least = 0.0f;
        if constexpr (NR > 1) {
          // the warp's least d2; fminf passes over NaN
          float lo = d2[0][0];
#pragma unroll
          for (int m = 0; m < MT_RM; ++m)
#pragma unroll
            for (int n = 0; n < MT_RN; ++n) lo = fminf(lo, d2[m][n]);
          least = __uint_as_float(
              __reduce_min_sync(FULL_MASK, __float_as_uint(lo)));
          tally += 1u << 8;
          if (!(least <= r2max)) continue;  // no radius reached
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if constexpr (NR > 1) {
            if (rad.template w<EXACT>(r, least) == 0.0f) continue;
            tally = (tally | (1u << r)) + (1u << 16);
          }
          // column counts onto 2^23: the float's low byte is the count
          float cc[MT_RN];
#pragma unroll
          for (int n = 0; n < MT_RN; ++n) cc[n] = 8388608.0f;
#pragma unroll
          for (int m = 0; m < MT_RM; ++m)
#pragma unroll
            for (int n = 0; n < MT_RN; ++n) {
              const float w = rad.template w<EXACT>(r, d2[m][n]);
              ones[r][m] += __float_as_uint(w);
              cc[n] += w;
            }
          // four 8-bit column fields, added over the warp's thread rows
          unsigned p = __byte_perm(
              __byte_perm(__float_as_uint(cc[0]), __float_as_uint(cc[1]),
                          0x0040),
              __byte_perm(__float_as_uint(cc[2]), __float_as_uint(cc[3]),
                          0x0040),
              0x5410);
          p += __shfl_xor_sync(FULL_MASK, p, MT_TC);
          p += __shfl_xor_sync(FULL_MASK, p, 2 * MT_TC);
          if (word_lane) slot[r * n_warps * CW] = p;
        }
      }
      if constexpr (NR > 1) {
        // the row counts of the radii the warp ran, into the pass's
        // shared ones (registers for them would spill at NR = 8)
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if (!((tally >> r) & 1u)) continue;
#pragma unroll
          for (int m = 0; m < MT_RM; ++m) {
            const int c = decode_ones(ones[r][m]);
            if (c != 0)
              atomicAdd(&s_rcnt[r * rows_per_pass + tr + n_tr * m], c);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int m = 0; m < MT_RM; ++m)
            rcnt[r][m] += decode_ones(ones[r][m]);
      }
      if (NR > 1 && (tid & 31) == 0) {
        s_live[warp] = tally & 0xffu;
        if (tally != 0u) {
          atomicAdd(&s_steps[0], (tally >> 8) & 0xffu);
          atomicAdd(&s_steps[1], tally >> 16);
        }
      }
      tally = 0u;
      __syncthreads();
      // the chunk's column counts: the warps' words added, one atomicAdd
      // per non-zero column and radius; with several radii only the radii
      // that a warp ran, their words put back to 0
      unsigned any = 1u;
      if constexpr (NR > 1) {
        any = 0u;
        for (int w = 0; w < n_warps; ++w) any |= s_live[w];
      }
      const int words = (ch + MT_RN - 1) / MT_RN;
      for (int e = tid; e < NR * words; e += blockDim.x) {
        const int r = e / words;
        const int c4 = e - r * words;
        if (NR > 1 && !((any >> r) & 1u)) continue;
        unsigned s = 0;
        for (int w = 0; w < n_warps; ++w) {
          unsigned* word = &s_colw[(r * n_warps + w) * CW + c4];
          s += *word;
          if (NR > 1) *word = 0u;
        }
        if (s == 0u || r >= n_radii) continue;
        int* o = out + (int64_t)r * n_pad + col0 + MT_RN * c4;
#pragma unroll
        for (int f = 0; f < MT_RN; ++f) {
          const int v = (int)((s >> (8 * f)) & 0xffu);
          if (v != 0) atomicAdd(&o[f], v);
        }
      }
    }

    if constexpr (NR > 1) {
      // rows: the pass's shared counts (the last chunk's fold came after
      // its __syncthreads), put back to 0 for the next pass; rows outside
      // the sweep were NaN and counted nothing
      for (int e = tid; e < NR * rows_per_pass; e += blockDim.x) {
        const int c = s_rcnt[e];
        if (c == 0) continue;
        s_rcnt[e] = 0;
        const int r = e / rows_per_pass;
        atomicAdd(&out[(int64_t)r * n_pad + rmin + (e - r * rows_per_pass)],
                  c);
      }
    } else {
      // rows: fold across the MT_TC threads of each row
#pragma unroll
      for (int r = 0; r < NR; ++r) {
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) {
          int c = rcnt[r][m];
#pragma unroll
          for (int off = MT_TC / 2; off > 0; off >>= 1)
            c += __shfl_xor_sync(FULL_MASK, c, off);
          if (tc == 0 && ok[m] && r < n_radii && c != 0)
            atomicAdd(&out[(int64_t)r * n_pad + row[m]], c);
        }
      }
    }
  }

  if constexpr (NR > 1) {
    if (steps != nullptr) {
      __syncthreads();
      if (tid < 2 && s_steps[tid] != 0u)
        atomicAdd(&steps[2 * (blockIdx.x % STEP_SLOTS) + tid],
                  (unsigned long long)s_steps[tid]);
    }
  }
}

// The exact compare for radii below 2^-100, in one runtime-D instance per
// radius bucket (its 32-column chunks and words fit every instance's
// shared memory).
template <int NR>
__device__ __noinline__ void count_tile_exact(
    ck::CountRadii<NR> rad, float* smem, const float* __restrict__ ct,
    int64_t n_pad, int d, int n_radii, int n_valid, int64_t row0,
    int64_t colbase, int row_block, int col_block, int* __restrict__ out,
    unsigned long long* __restrict__ steps) {
  count_tile<0, NR, true>(rad, smem, ct, n_pad, d, n_radii, n_valid, row0,
                          colbase, row_block, col_block, out, steps);
}

template <int DT, int NR>
__global__ void __launch_bounds__(ck::MT_MAX_TR * ck::MT_TC,
                                  ck::mt_count_ctas(DT, NR))
pops_bidir_kernel(const float* __restrict__ ct, int64_t n_pad, int d,
                  const float* __restrict__ radii2, int n_radii, int n_valid,
                  const int* __restrict__ ti, const int* __restrict__ tj,
                  const int* __restrict__ rmask, int row_block,
                  int col_block, int* __restrict__ out,
                  unsigned long long* __restrict__ steps) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  const int j = tj[t];
  const int rm = rmask[t];
  if (j < 0 || rm == 0) return;  // no-op pad, or no radius admissible
  const int64_t row0 = (int64_t)ti[t] * row_block;
  const int64_t colbase = (int64_t)j * col_block;
  if (colbase >= n_valid) return;

  ck::CountRadii<NR> rad;
  rad.setup(radii2, n_radii, (unsigned)rm);
  if (rad.exact)
    count_tile_exact<NR>(rad, smem, ct, n_pad, d, n_radii, n_valid, row0,
                         colbase, row_block, col_block, out, steps);
  else
    count_tile<DT, NR, false>(rad, smem, ct, n_pad, d, n_radii, n_valid,
                              row0, colbase, row_block, col_block, out,
                              steps);
}

}  // namespace

extern "C" int ck_pops_bidir(const float* coords_t, long long n_pad, int d,
                             const float* radii2, int n_radii, int n_valid,
                             const int* ti, const int* tj, const int* rmask,
                             long long n_tiles, int row_block, int col_block,
                             int* out, unsigned long long* steps,
                             void* stream) {
  if (n_radii < 1 || n_radii > ck::MAX_RADII || row_block < 1 ||
      row_block > 1024 || col_block < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int threads = ck::mt_count_threads(row_block);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, CK_DISPATCH_NR(n_radii, NR, {
    constexpr int CH = ck::MtChunk<DT>::value;
    const size_t smem =
        (size_t)2 * CH * d * sizeof(float) +
        (size_t)NR * (threads / 32) * (CH / ck::MT_RN) * sizeof(unsigned) +
        (NR > 1 ? (size_t)(threads / 32 + 2 +
                           NR * (threads / ck::MT_TC) * ck::MT_RM) *
                      sizeof(unsigned)
                : 0);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(pops_bidir_kernel<DT, NR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    pops_bidir_kernel<DT, NR><<<(unsigned)n_tiles, threads, smem, st>>>(
        coords_t, (int64_t)n_pad, d, radii2, n_radii, n_valid, ti, tj, rmask,
        row_block, col_block, out, steps);
  }));
  return (int)cudaGetLastError();
}
