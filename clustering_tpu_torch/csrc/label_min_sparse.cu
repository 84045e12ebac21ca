// Row-side screening proposals over a tile list that holds both
// orientations (the symmetric sweep): the minimum neighbour label over the
// graph d2 < max_dist2 restricted to the first n_below frames.
//
// Replaces the TPU kernel clustering_tpu/ops/pallas_kernels.py:
// _label_min_sparse_kernel (called through label_min_sparse_cross). Rows
// come from a (D, R_pad) matrix whose first frame is the global position
// row_block_offset * row_block (a shard's rows; 0 on one device), columns
// from the (D, N_pad) matrix with its labels. A tile is swept when its
// COLUMN block is dirty (dirty[tj]: the column labels changed since the
// last sweep); each pair with d2 < max_dist2 and both global positions
// below n_below proposes labels[col] to the row. The caller initialises
// the (R_pad,) proposal buffer to INT32_MAX and takes min(labels, prop)
// afterwards; labels are read, never written, so one launch over the flat
// list is a Jacobi sweep (the TPU route folds chunks Gauss-Seidel: sweep
// counts may differ, the fixpoint does not).
//
// What bounds it on the H100: per pair, D fp32 subtract + fma and one
// compare + min; every pair is evaluated once per orientation. The TPU
// wrote a row block's proposals on its first visit and relied on a
// row-sorted list run in order; here each thread keeps its row's minimum
// in a register for the whole tile and issues one atomicMin, only when it
// found a proposal. Column labels are staged in shared memory beside the
// coordinates.

#include "common.cuh"

namespace {

constexpr int IMAX = 0x7FFFFFFF;

template <int DT>
__global__ void label_min_sparse_kernel(const float* __restrict__ rows_t,
                                        int64_t r_pad,
                                        const float* __restrict__ cols_t,
                                        int64_t n_pad, int d,
                                        const int* __restrict__ labels,
                                        int n_below, float max_dist2,
                                        const int* __restrict__ ti,
                                        const int* __restrict__ tj,
                                        int row_block_offset,
                                        const int* __restrict__ dirty,
                                        int row_block, int col_block,
                                        int* __restrict__ prop) {
  constexpr int CH = ck::Chunk<DT>::value;
  extern __shared__ int smem_i32[];
  int* s_lab = smem_i32;                              // CH
  float* ys = reinterpret_cast<float*>(s_lab + CH);  // d * CH

  const int k = blockIdx.x;
  const int i = ti[k];
  const int j = tj[k];
  // no-op pad, or the column block's labels did not change
  if (j < 0 || dirty[j] == 0) return;
  const int64_t grow0 = ((int64_t)row_block_offset + i) * row_block;
  if (grow0 >= n_below) return;  // every row of the tile is above n_below

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)i * row_block;
  const int64_t row = row0 + tid;
  const bool row_on = tid < row_block && grow0 + tid < n_below;
  const int64_t colbase = (int64_t)j * col_block;

  ck::RowCoords<DT> x;
  x.load(rows_t, r_pad, tid < row_block ? row : row0, d);
  int best = IMAX;

  for (int off = 0; off < col_block; off += CH) {
    const int64_t col0 = colbase + off;
    const int ch = min(CH, col_block - off);
    if (col0 >= n_below) break;
    // columns at or past n_below propose nothing
    const int lim = min(ch, (int)(n_below - col0));
    __syncthreads();
    ck::stage_cols(ys, cols_t, n_pad, d, col0, ch);
    for (int c = tid; c < lim; c += blockDim.x) s_lab[c] = labels[col0 + c];
    __syncthreads();
    for (int c = 0; c < lim; ++c) {
      const float d2 = x.dist2(ys, ch, c, d);
      if (d2 < max_dist2) best = min(best, s_lab[c]);
    }
  }
  if (row_on && best < IMAX) atomicMin(&prop[row], best);
}

}  // namespace

extern "C" int ck_label_min_sparse(const float* rows_t, long long r_pad,
                                   const float* cols_t, long long n_pad,
                                   int d, const int* labels, int n_below,
                                   float max_dist2, const int* ti,
                                   const int* tj, int row_block_offset,
                                   const int* dirty, long long n_tiles,
                                   int row_block, int col_block, int* prop,
                                   void* stream) {
  if (row_block < 1 || row_block > 1024) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int threads = ck::cta_threads(row_block);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    constexpr int CH = ck::Chunk<DT>::value;
    const size_t smem = (size_t)CH * sizeof(int) + ck::col_smem_bytes(DT, d);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(label_min_sparse_kernel<DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    label_min_sparse_kernel<DT><<<(unsigned)n_tiles, threads, smem, st>>>(
        rows_t, (int64_t)r_pad, cols_t, (int64_t)n_pad, d, labels, n_below,
        max_dist2, ti, tj, row_block_offset, dirty, row_block, col_block,
        prop);
  });
  return (int)cudaGetLastError();
}
