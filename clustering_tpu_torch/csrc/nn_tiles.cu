// Joint nearest-neighbour / nearest-lower-free-energy neighbour search over
// a dense (row block x column block) grid whose tiles are kept or skipped
// by bit-packed skip words.
//
// Replaces the TPU kernel clustering_tpu/ops/pallas_kernels.py: _nn_kernel
// (called through nn_tiles_cross). Rows come from a (D, R_pad) matrix with
// their free energies, columns from a (D, N_pad) matrix with theirs and
// their original ids (the cross form; nn_tiles passes one matrix twice).
// Tile (i, j) is skipped iff bit j % 32 of word i * words_per_row + j / 32
// is set. A row's candidates in a kept tile are the columns below n_valid
// with 0 < d2 < inf; hd candidates also need strictly lower free energy
// (fe is +inf on pad columns). Each row keeps two lexicographic
// (d2, original id) minima, so ties go to the smaller original id.
//
// Results are in ROW POSITION (unlike nn_sparse.cu and nn_bidir.cu, which
// key by original id): a (2, R_pad) [nh; hd] buffer of 64-bit keys
// (float_bits(d2) << 32) | original_id, which the wrapper fills with
// KEY_NONE = (bits(+inf) << 32) | INT32_MAX before the launch and unpacks
// into (d2, id) afterwards. atomicMin on the key is the exact
// lexicographic minimum in any CTA order. A d2 of +inf never writes a key,
// so no id latches at infinite distance, and a row block whose every tile
// is skipped reports (+inf, INT32_MAX), as the TPU kernel's first-step
// fill does.
//
// Grid: one CTA per cell of the grid, flattened onto blockIdx.x (gridDim.y
// stops at 65535 row blocks) in waves by distance from each row block's
// diagonal column block: blockIdx.x = k * n_row_blocks + i is cell k of
// row block i in the order jd, jd + 1, jd - 1, jd + 2, ... (jd the column
// block that holds the row block's first frame; the longer side alone
// once the shorter ends). On a Morton-like layout a row's neighbours sit
// near the diagonal, so the cells that start later find tight keys in the
// buffer and the filter below drops nearly all their pairs; in row-major
// order every cell of a row block started together from KEY_NONE, and
// the same calls took 1.5x as long (kernel_ab.py, H100 80GB HBM3, 700 W).
// The results do not depend on the order. A CTA reads its skip word first
// and returns at once when its bit is set. Per-cell CTAs rather than one
// CTA per row block keep the card busy when pruning leaves row blocks with
// very different numbers of kept cells.
//
// What bounds it on the H100: the FP32 pipe, 3 * D flops per pair of a
// kept tile (D subtractions, D fmas). Beside them each pair feeds two
// (d2, id) minima, a 64-bit compare and select each on the integer pipe
// at half the FP32 rate, which held the one-thread-per-row version near
// 0.18 of the FP32 bound. The design is nn_bidir.cu's row side:
//  - register micro-tiles (common.cuh, ck::nn_cell, shared with
//    nn_sparse.cu): a thread holds MT_RM rows for the pass and evaluates
//    MT_RM x MT_RN pairs per step, 16 independent fma chains, columns read
//    as one float4 per dimension;
//  - a filter on the FP32 pipe, exact: each row carries a threshold
//    T = nextafter(d2 of the larger of its two held keys); a pair can
//    lower a key only if d2 - T is negative, so the step ORs the sign
//    words of d2 - T per row (one subtraction and one OR per pair) and
//    runs the exact update in the shifted key domain of common.cuh only
//    for the rows whose sign is set (d2 = 0 and the NaN-staged columns
//    cost no test there);
//  - row keys start from the buffer (keys[row], keys[r_pad + row]), read
//    at each pass start: keys held there are never below the final
//    minima, so the filter stays exact whatever order the CTAs run in,
//    and a cell that starts after another cell of its row block has
//    written starts from that cell's thresholds;
//  - rows fold across the MT_TC threads of a row by shuffles at the
//    pass's end: one atomicMin per row and side, only where the row
//    improves the buffer;
//  - 512-column chunks, double-buffered: coordinates, free energies and
//    original ids of the next chunk come in by 16-byte cp.async while the
//    current one is computed; columns at or past n_valid are staged as
//    NaN coordinates with fe NaN, so the inner loop has no bounds tests.
// The distance stays the fma chain from zero in ascending dimension order
// (no tensor cores, no |x|^2 + |y|^2 - 2xy), so the results are bit-equal
// to the plain version and to the Pallas kernel.

#include "common.cuh"

namespace {

template <int DT>
__global__ void __launch_bounds__(ck::MT_MAX_TR * ck::MT_TC,
                                  DT >= 1 && DT <= 8 ? 3 : 2)
nn_tiles_kernel(const float* __restrict__ rows_t, int64_t r_pad,
                const float* __restrict__ fe_rows,
                const float* __restrict__ cols_t, int64_t n_pad, int d,
                const float* __restrict__ fe_cols,
                const int* __restrict__ orig_ids, int n_valid,
                const int* __restrict__ skip_words, int words_per_row,
                int n_col_blocks, int row_block, int col_block,
                ck::u64* __restrict__ keys) {
  extern __shared__ __align__(16) float smem_f32[];

  // cell k of row block i in the diagonal-first order (above)
  const int64_t nrb = gridDim.x / n_col_blocks;
  const int64_t i = blockIdx.x % nrb;
  const int k = (int)(blockIdx.x / nrb);
  const int jd = (int)min((int64_t)(n_col_blocks - 1),
                          i * row_block / col_block);
  const int left = jd, right = n_col_blocks - 1 - jd;
  const int mlr = min(left, right);
  const int j = k <= 2 * mlr ? jd + ((k & 1) ? (k + 1) / 2 : -(k / 2))
                : right > left ? jd + (k - mlr) : jd - (k - mlr);
  const unsigned word =
      (unsigned)skip_words[i * words_per_row + (j >> 5)];
  if ((word >> (j & 31)) & 1u) return;  // pruned tile
  const int64_t colbase = (int64_t)j * col_block;
  if (colbase >= n_valid) return;  // no column below n_valid
  // keys in row position: a (2, R_pad) buffer
  ck::nn_cell<DT, false>(smem_f32, rows_t, r_pad, fe_rows, nullptr, cols_t,
                         n_pad, d, fe_cols, orig_ids, n_valid,
                         i * row_block, colbase, row_block, col_block, keys,
                         r_pad);
}

}  // namespace

extern "C" int ck_nn_tiles(const float* rows_t, long long r_pad,
                           const float* fe_rows, const float* cols_t,
                           long long n_pad, int d, const float* fe_cols,
                           const int* orig_ids, int n_valid,
                           const int* skip_words, int words_per_row,
                           int row_block, int col_block,
                           unsigned long long* keys, void* stream) {
  if (row_block < 1 || row_block > 1024 || col_block < 1 ||
      r_pad % row_block != 0 || n_pad % col_block != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_col_blocks = n_pad / col_block;
  const long long cells = (r_pad / row_block) * n_col_blocks;
  if (cells > 0x7FFFFFFFll || words_per_row != (n_col_blocks + 31) / 32)
    return (int)cudaErrorInvalidValue;
  if (cells == 0) return (int)cudaGetLastError();
  const int threads = ck::mt_thread_rows(row_block) * ck::MT_TC;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    constexpr int CH = ck::MtChunk<DT>::value;
    const size_t smem = ck::nn_cell_smem_bytes(CH, d);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(nn_tiles_kernel<DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    nn_tiles_kernel<DT><<<(unsigned)cells, threads, smem, st>>>(
        rows_t, (int64_t)r_pad, fe_rows, cols_t, (int64_t)n_pad, d, fe_cols,
        orig_ids, n_valid, skip_words, words_per_row, (int)n_col_blocks,
        row_block, col_block, keys);
  });
  return (int)cudaGetLastError();
}
