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
//    chunk's fold reads eight words per four columns.
// The distance is the fma chain from zero in ascending dimension order and
// the count is exactly `d2 <= r^2`, so the counts are the plain version's
// and the Pallas kernel's.

#include "common.cuh"

namespace {

// The passes of one listed tile. smem holds two column chunks, then the
// warps' column words (NR x warps x CH / MT_RN).
template <int DT, int NR, bool EXACT>
__device__ __forceinline__ void count_tile(
    const ck::CountRadii<NR>& rad, float* smem,
    const float* __restrict__ ct, int64_t n_pad, int d, int n_radii,
    int n_valid, int64_t row0, int64_t colbase, int row_block,
    int col_block, int* __restrict__ out) {
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
          if (word_lane) {
#pragma unroll
            for (int r = 0; r < NR; ++r) slot[r * n_warps * CW] = 0u;
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
#pragma unroll
        for (int r = 0; r < NR; ++r) {
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
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) rcnt[r][m] += decode_ones(ones[r][m]);
      __syncthreads();
      // the chunk's column counts: the warps' words added, one atomicAdd
      // per non-zero column and radius
      const int words = (ch + MT_RN - 1) / MT_RN;
      for (int e = tid; e < NR * words; e += blockDim.x) {
        const int r = e / words;
        const int c4 = e - r * words;
        unsigned s = 0;
        for (int w = 0; w < n_warps; ++w)
          s += s_colw[(r * n_warps + w) * CW + c4];
        if (s == 0u || r >= n_radii) continue;
        int* o = out + (int64_t)r * n_pad + col0 + MT_RN * c4;
#pragma unroll
        for (int f = 0; f < MT_RN; ++f) {
          const int v = (int)((s >> (8 * f)) & 0xffu);
          if (v != 0) atomicAdd(&o[f], v);
        }
      }
    }

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

// The exact compare for radii below 2^-100, in one runtime-D instance per
// radius bucket (its 32-column chunks and words fit every instance's
// shared memory).
template <int NR>
__device__ __noinline__ void count_tile_exact(
    ck::CountRadii<NR> rad, float* smem, const float* __restrict__ ct,
    int64_t n_pad, int d, int n_radii, int n_valid, int64_t row0,
    int64_t colbase, int row_block, int col_block, int* __restrict__ out) {
  count_tile<0, NR, true>(rad, smem, ct, n_pad, d, n_radii, n_valid, row0,
                          colbase, row_block, col_block, out);
}

template <int DT, int NR>
__global__ void __launch_bounds__(ck::MT_MAX_TR * ck::MT_TC,
                                  ck::mt_count_ctas(DT, NR))
pops_bidir_kernel(const float* __restrict__ ct, int64_t n_pad, int d,
                  const float* __restrict__ radii2, int n_radii, int n_valid,
                  const int* __restrict__ ti, const int* __restrict__ tj,
                  const int* __restrict__ rmask, int row_block,
                  int col_block, int* __restrict__ out) {
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
                         colbase, row_block, col_block, out);
  else
    count_tile<DT, NR, false>(rad, smem, ct, n_pad, d, n_radii, n_valid,
                              row0, colbase, row_block, col_block, out);
}

}  // namespace

extern "C" int ck_pops_bidir(const float* coords_t, long long n_pad, int d,
                             const float* radii2, int n_radii, int n_valid,
                             const int* ti, const int* tj, const int* rmask,
                             long long n_tiles, int row_block, int col_block,
                             int* out, void* stream) {
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
        (size_t)NR * (threads / 32) * (CH / ck::MT_RN) * sizeof(unsigned);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(pops_bidir_kernel<DT, NR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    pops_bidir_kernel<DT, NR><<<(unsigned)n_tiles, threads, smem, st>>>(
        coords_t, (int64_t)n_pad, d, radii2, n_radii, n_valid, ti, tj, rmask,
        row_block, col_block, out);
  }));
  return (int)cudaGetLastError();
}
