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
// Design: one CTA per cell of the grid, flattened row-major onto
// blockIdx.x (gridDim.y stops at 65535 row blocks; x takes 2^31 - 1
// cells). A CTA reads its skip word first and returns at once when its
// bit is set, so a skipped cell costs one broadcast word read: a 2^21-cell
// grid with every bit set takes 1.3 ms on an H100 (700 W). A kept cell
// runs as pops_sparse.cu: one thread per row, columns staged through
// shared memory, counts in registers, one atomicAdd per row and radius.
// One CTA per row block walking its column blocks would need no atomics,
// but pruned row blocks keep from a few to all of their cells, so it
// would leave SMs idle behind the longest rows; per-cell CTAs spread
// every row block's kept cells over the whole card.
// The TPU zeroed a row block's counts on its first grid step (outside the
// skip test) and accumulated in VMEM across the in-order column sweep;
// CTAs run in any order, so the wrapper zeroes the output before the
// launch and a row block whose every tile is skipped reports zeros.
//
// What bounds it on the H100: per pair of a kept tile, D fp32 subtract +
// fma and one compare + add per radius, with the columns broadcast from
// shared memory; skipped cells cost a CTA launch and one word.

#include "common.cuh"

namespace {

constexpr int MAX_R = 8;  // radii per launch; the wrapper groups larger sets

template <int DT>
__global__ void pops_tiles_kernel(const float* __restrict__ rows_t,
                                  int64_t r_pad,
                                  const float* __restrict__ cols_t,
                                  int64_t n_pad, int d,
                                  const float* __restrict__ radii2,
                                  int n_radii, int n_valid,
                                  const int* __restrict__ skip_words,
                                  int words_per_row, int n_col_blocks,
                                  int row_block, int col_block,
                                  int* __restrict__ out) {
  constexpr int CH = ck::Chunk<DT>::value;
  extern __shared__ float ys[];  // d * CH

  const int64_t cell = blockIdx.x;
  const int64_t i = cell / n_col_blocks;
  const int j = (int)(cell - i * n_col_blocks);
  const unsigned word =
      (unsigned)skip_words[i * words_per_row + (j >> 5)];
  if ((word >> (j & 31)) & 1u) return;  // pruned tile

  const int tid = threadIdx.x;
  const int64_t row0 = i * row_block;
  const int64_t row = row0 + tid;
  const bool row_on = tid < row_block;
  const int64_t colbase = (int64_t)j * col_block;

  float r2[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) r2[r] = r < n_radii ? radii2[r] : 0.0f;

  ck::RowCoords<DT> x;
  x.load(rows_t, r_pad, row_on ? row : row0, d);

  int cnt[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) cnt[r] = 0;

  for (int off = 0; off < col_block; off += CH) {
    const int64_t col0 = colbase + off;
    const int ch = min(CH, col_block - off);
    if (col0 >= n_valid) break;
    // columns at or past n_valid are pads: they count for no row
    const int lim = min(ch, (int)(n_valid - col0));
    __syncthreads();
    ck::stage_cols(ys, cols_t, n_pad, d, col0, ch);
    __syncthreads();
    for (int c = 0; c < lim; ++c) {
      const float d2 = x.dist2(ys, ch, c, d);
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) {
        if (r < n_radii) cnt[r] += d2 <= r2[r];
      }
    }
  }
  if (row_on) {
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (cnt[r] != 0) atomicAdd(&out[(int64_t)r * r_pad + row], cnt[r]);
    }
  }
}

}  // namespace

extern "C" int ck_pops_tiles(const float* rows_t, long long r_pad,
                             const float* cols_t, long long n_pad, int d,
                             const float* radii2, int n_radii, int n_valid,
                             const int* skip_words, int words_per_row,
                             int row_block, int col_block, int* out,
                             void* stream) {
  if (n_radii < 1 || n_radii > MAX_R || row_block < 1 || row_block > 1024 ||
      col_block < 1 || r_pad % row_block != 0 || n_pad % col_block != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_col_blocks = n_pad / col_block;
  const long long cells = (r_pad / row_block) * n_col_blocks;
  if (cells > 0x7FFFFFFFll || words_per_row != (n_col_blocks + 31) / 32)
    return (int)cudaErrorInvalidValue;
  if (cells == 0) return (int)cudaGetLastError();
  const int threads = ck::cta_threads(row_block);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    const size_t smem = ck::col_smem_bytes(DT, d);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(pops_tiles_kernel<DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    pops_tiles_kernel<DT><<<(unsigned)cells, threads, smem, st>>>(
        rows_t, (int64_t)r_pad, cols_t, (int64_t)n_pad, d, radii2, n_radii,
        n_valid, skip_words, words_per_row, (int)n_col_blocks, row_block,
        col_block, out);
  });
  return (int)cudaGetLastError();
}
