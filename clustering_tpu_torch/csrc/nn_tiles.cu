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
// into (d2, id) afterwards. d2 >= 0 keeps the bit order equal to the float
// order, so atomicMin on the key is the exact lexicographic minimum in any
// CTA order. A d2 of +inf never writes a key, so no id latches at infinite
// distance, and a row block whose every tile is skipped reports
// (+inf, INT32_MAX), as the TPU kernel's first-step fill does.
//
// Design: one CTA per cell of the grid, flattened row-major onto
// blockIdx.x (gridDim.y stops at 65535 row blocks); a CTA reads its skip
// word first and returns at once when its bit is set (a 2^21-cell grid
// with every bit set takes 1.3 ms on an H100, 700 W). A kept cell runs as
// nn_sparse.cu: one thread per row, the column coordinates, free energies
// and ids staged in shared memory, the two minima in registers, at most
// one atomicMin per row and side. As in pops_tiles.cu, per-cell CTAs
// rather than one CTA per row block keep the card busy when pruning
// leaves row blocks with very different numbers of kept cells.
//
// What bounds it on the H100: per pair of a kept tile, D fp32 subtract +
// fma and two compare/select minima on 64-bit keys; skipped cells cost a
// CTA launch and one word.

#include "common.cuh"

namespace {

constexpr unsigned long long KEY_NONE =
    (0x7F800000ull << 32) | 0x7FFFFFFFull;

__device__ __forceinline__ unsigned long long make_key(float d2, int oid) {
  return ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)oid;
}

template <int DT>
__global__ void nn_tiles_kernel(const float* __restrict__ rows_t,
                                int64_t r_pad,
                                const float* __restrict__ fe_rows,
                                const float* __restrict__ cols_t,
                                int64_t n_pad, int d,
                                const float* __restrict__ fe_cols,
                                const int* __restrict__ orig_ids,
                                int n_valid,
                                const int* __restrict__ skip_words,
                                int words_per_row, int n_col_blocks,
                                int row_block, int col_block,
                                unsigned long long* __restrict__ keys) {
  constexpr int CH = ck::Chunk<DT>::value;
  extern __shared__ float smem_f32[];
  float* s_fe = smem_f32;                             // CH
  int* s_oid = reinterpret_cast<int*>(s_fe + CH);     // CH
  float* ys = reinterpret_cast<float*>(s_oid + CH);   // d * CH

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

  ck::RowCoords<DT> x;
  x.load(rows_t, r_pad, row_on ? row : row0, d);
  const float fe_x = row_on ? fe_rows[row] : __int_as_float(0x7f800000);
  unsigned long long my_nh = KEY_NONE, my_hd = KEY_NONE;

  for (int off = 0; off < col_block; off += CH) {
    const int64_t col0 = colbase + off;
    const int ch = min(CH, col_block - off);
    if (col0 >= n_valid) break;
    // columns at or past n_valid are pads: never candidates
    const int lim = min(ch, (int)(n_valid - col0));
    __syncthreads();
    ck::stage_cols(ys, cols_t, n_pad, d, col0, ch);
    for (int c = tid; c < lim; c += blockDim.x) {
      s_fe[c] = fe_cols[col0 + c];
      s_oid[c] = orig_ids[col0 + c];
    }
    __syncthreads();
    for (int c = 0; c < lim; ++c) {
      const float d2 = x.dist2(ys, ch, c, d);
      if (d2 > 0.0f && d2 < __int_as_float(0x7f800000)) {
        const unsigned long long kr = make_key(d2, s_oid[c]);
        my_nh = kr < my_nh ? kr : my_nh;
        if (s_fe[c] < fe_x) my_hd = kr < my_hd ? kr : my_hd;
      }
    }
  }
  if (row_on) {
    if (my_nh != KEY_NONE) atomicMin(&keys[row], my_nh);
    if (my_hd != KEY_NONE) atomicMin(&keys[r_pad + row], my_hd);
  }
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
  const int threads = ck::cta_threads(row_block);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    constexpr int CH = ck::Chunk<DT>::value;
    const size_t smem = (size_t)CH * (sizeof(float) + sizeof(int)) +
                        ck::col_smem_bytes(DT, d);
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
