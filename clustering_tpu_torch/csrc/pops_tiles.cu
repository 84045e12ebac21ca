// Multi-radius population counts over a dense (row block x column block)
// grid whose tiles are kept or skipped by bit-packed skip words.
//
// Replaces the TPU kernel clustering_tpu/ops/pallas_kernels.py:
// _pops_kernel (called through pops_tiles_cross). Rows come from a
// (D, R_pad) matrix and columns from a (D, N_pad) matrix (the cross form;
// pops_tiles passes one matrix twice). Tile (i, j) is skipped iff bit
// j % 32 of word i * words_per_row + j / 32 is set. Every pair of a kept
// tile with col < n_valid and d2 <= r^2 adds 1 to the ROW frame's count at
// radius r, for every radius. The self pair counts (d2 = 0), so no
// diagonal +1 follows; pad rows at 3e38 overflow to d2 = inf and count
// nothing.
//
// Grid: one CTA per cell of the grid, flattened row-major onto blockIdx.x
// (gridDim.y stops at 65535 row blocks; x takes 2^31 - 1 cells). A CTA
// reads its skip word first and returns at once when its bit is set, so a
// skipped cell costs a CTA launch and one broadcast word read. One CTA per
// row block walking its column blocks would need no atomics, but pruned
// row blocks keep from a few to all of their cells, so it would leave SMs
// idle behind the longest rows; per-cell CTAs spread every row block's
// kept cells over the whole card (a grid-stride loop over skip words was
// slower on the card for that reason). The TPU zeroed a
// row block's counts on its first grid step (outside the skip test) and
// accumulated in VMEM across the in-order column sweep; CTAs run in any
// order, so the wrapper zeroes the output before the launch and a row
// block whose every tile is skipped reports zeros.
//
// What bounds it on the H100: the FP32 pipe, 3 * D flops per pair of a
// kept tile (D subtractions, D fmas), beside the count. A kept cell runs
// ck::count_cell (common.cuh, shared with pops_sparse.cu, which drives it
// by a tile list) on the register micro-tiles, as pops_bidir.cu without
// its column side and diagonal: a thread holds MT_RM rows for the pass and
// evaluates MT_RM x MT_RN pairs per step (16 independent fma chains, one
// float4 of columns per dimension); 512-column chunks come in by 16-byte
// cp.async, double-buffered; columns at or past n_valid are staged as
// NaN, so `d2 <= r^2` alone decides a count. The count is one saturating
// fma per pair and radius (ck::CountRadii: w = 1.0f or 0.0f, exact) whose
// float bits add two at a time in IADD3s and are decoded once per chunk
// (ck::decode_ones); instances for 1, 2, 4 or 8 radii, so one radius costs
// one compare per pair. Counts stay in registers, fold across the MT_TC
// threads of a row by shuffles, then one atomicAdd per row and radius
// where non-zero. A radius below 2^-100 (r = 0) takes the exact compare
// in a runtime-D instance.

#include "common.cuh"

namespace {

template <int DT, int NR>
__global__ void __launch_bounds__(ck::MT_MAX_TR * ck::MT_TC,
                                  ck::mt_count_ctas(DT, NR))
pops_tiles_kernel(const float* __restrict__ rows_t, int64_t r_pad,
                  const float* __restrict__ cols_t, int64_t n_pad, int d,
                  const float* __restrict__ radii2, int n_radii, int n_valid,
                  const int* __restrict__ skip_words, int words_per_row,
                  int n_col_blocks, int row_block, int col_block,
                  int* __restrict__ out) {
  extern __shared__ __align__(16) float ys[];  // 2 x d * CH

  const int64_t cell = blockIdx.x;
  const int64_t i = cell / n_col_blocks;
  const int j = (int)(cell - i * n_col_blocks);
  const unsigned word =
      (unsigned)skip_words[i * words_per_row + (j >> 5)];
  if ((word >> (j & 31)) & 1u) return;  // pruned tile
  const int64_t row0 = i * row_block;
  const int64_t colbase = (int64_t)j * col_block;
  if (colbase >= n_valid) return;  // no column below n_valid

  ck::CountRadii<NR> rad;
  rad.setup(radii2, n_radii, ~0u);
  if (rad.exact)
    ck::count_cell_exact<NR>(rad, ys, rows_t, r_pad, cols_t, n_pad, d, n_radii,
                         n_valid, row0, colbase, row_block, col_block, out);
  else
    ck::count_cell<DT, NR, false>(rad, ys, rows_t, r_pad, cols_t, n_pad, d,
                              n_radii, n_valid, row0, colbase, row_block,
                              col_block, out);
}

}  // namespace

extern "C" int ck_pops_tiles(const float* rows_t, long long r_pad,
                             const float* cols_t, long long n_pad, int d,
                             const float* radii2, int n_radii, int n_valid,
                             const int* skip_words, int words_per_row,
                             int row_block, int col_block, int* out,
                             void* stream) {
  if (n_radii < 1 || n_radii > ck::MAX_RADII || row_block < 1 ||
      row_block > 1024 || col_block < 1 || r_pad % row_block != 0 ||
      n_pad % col_block != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_col_blocks = n_pad / col_block;
  const long long cells = (r_pad / row_block) * n_col_blocks;
  if (cells > 0x7FFFFFFFll || words_per_row != (n_col_blocks + 31) / 32)
    return (int)cudaErrorInvalidValue;
  if (cells == 0) return (int)cudaGetLastError();
  const int threads = ck::mt_count_threads(row_block);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, CK_DISPATCH_NR(n_radii, NR, {
    constexpr int CH = ck::MtChunk<DT>::value;
    const size_t smem = (size_t)2 * CH * d * sizeof(float);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(pops_tiles_kernel<DT, NR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    pops_tiles_kernel<DT, NR><<<(unsigned)cells, threads, smem, st>>>(
        rows_t, (int64_t)r_pad, cols_t, (int64_t)n_pad, d, radii2, n_radii,
        n_valid, skip_words, words_per_row, (int)n_col_blocks, row_block,
        col_block, out);
  }));
  return (int)cudaGetLastError();
}
