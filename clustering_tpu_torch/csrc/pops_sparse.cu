// Row-side multi-radius population counts over a tile list that holds both
// orientations (the symmetric sweep).
//
// Replaces the TPU kernel clustering_tpu/ops/pallas_kernels.py:
// _pops_sparse_kernel (called through pops_tiles_sparse_cross). Rows come
// from a (D, R_pad) matrix and columns from a (D, N_pad) matrix (the cross
// form; the single-device path passes one matrix twice). Each pair of a
// listed tile with col < n_valid and d2 <= r^2 adds 1 to the ROW frame's
// count at radius r, gated by bit r of the tile's rmask. The self pair
// counts (d2 = 0), so no diagonal +1 follows. Entries with tj < 0 or
// rmask 0 are no-ops. The TPU wrote a row block's counts on its first
// visit and relied on a row-sorted list run in order; CTAs run in any
// order, so the wrapper zeroes the output and each CTA adds its rows'
// counts with one atomicAdd per row and radius where non-zero.
//
// What bounds it on the H100: the FP32 pipe, 3 * D flops per pair of a
// listed tile (D subtractions, D fmas), beside the count; every unordered
// pair is evaluated once per orientation. The design is pops_tiles.cu's,
// driven by the tile list instead of skip words: CTA k reads ti[k], tj[k]
// and rmask[k] and runs ck::count_cell (common.cuh) on the tile. A thread
// holds MT_RM rows for the pass and evaluates MT_RM x MT_RN pairs per
// step (16 independent fma chains, one float4 of columns per dimension);
// 512-column chunks come in by 16-byte cp.async, double-buffered, columns
// at or past n_valid staged as NaN, so the inner loop has no bounds
// tests. The count is one saturating fma per pair and radius
// (ck::CountRadii, exact); the tile's rmask turns a radius off inside the
// same fma (w = +0), so a partial rmask costs no test per pair. A radius
// below 2^-100 (r = 0) takes the exact compare in a runtime-D instance.

#include "common.cuh"

namespace {

template <int DT, int NR>
__global__ void __launch_bounds__(ck::MT_MAX_TR * ck::MT_TC,
                                  ck::mt_count_ctas(DT, NR))
pops_sparse_kernel(const float* __restrict__ rows_t, int64_t r_pad,
                   const float* __restrict__ cols_t, int64_t n_pad, int d,
                   const float* __restrict__ radii2, int n_radii,
                   int n_valid, const int* __restrict__ ti,
                   const int* __restrict__ tj,
                   const int* __restrict__ rmask, int row_block,
                   int col_block, int* __restrict__ out) {
  extern __shared__ __align__(16) float ys[];  // 2 x d * CH

  const int k = blockIdx.x;
  const int j = tj[k];
  const unsigned rm = (unsigned)rmask[k];
  if (j < 0 || rm == 0) return;  // no-op pad, or no radius admissible
  const int64_t row0 = (int64_t)ti[k] * row_block;
  const int64_t colbase = (int64_t)j * col_block;
  if (colbase >= n_valid) return;  // no column below n_valid

  ck::CountRadii<NR> rad;
  rad.setup(radii2, n_radii, rm);
  if (rad.exact)
    ck::count_cell_exact<NR>(rad, ys, rows_t, r_pad, cols_t, n_pad, d,
                             n_radii, n_valid, row0, colbase, row_block,
                             col_block, out);
  else
    ck::count_cell<DT, NR, false>(rad, ys, rows_t, r_pad, cols_t, n_pad, d,
                                  n_radii, n_valid, row0, colbase,
                                  row_block, col_block, out);
}

}  // namespace

extern "C" int ck_pops_sparse(const float* rows_t, long long r_pad,
                              const float* cols_t, long long n_pad, int d,
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
    const size_t smem = (size_t)2 * CH * d * sizeof(float);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(pops_sparse_kernel<DT, NR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    pops_sparse_kernel<DT, NR><<<(unsigned)n_tiles, threads, smem, st>>>(
        rows_t, (int64_t)r_pad, cols_t, (int64_t)n_pad, d, radii2, n_radii,
        n_valid, ti, tj, rmask, row_block, col_block, out);
  }));
  return (int)cudaGetLastError();
}
