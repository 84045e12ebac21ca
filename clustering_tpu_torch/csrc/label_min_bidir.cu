// Bidirectional screening proposals: minimum neighbour label over the
// graph d2 < max_dist2 restricted to the first n_below frames.
//
// Replaces the TPU kernel clustering_tpu/ops/pallas_kernels.py:
// _label_min_bidir_kernel (called through label_min_sparse_bidir). Every
// listed tile (gated by its dirty flag) is evaluated once: rows take the
// labels of adjacent columns and columns the labels of adjacent rows. The
// kernel reads the labels and never writes them; all proposals go into ONE
// int32 buffer that the caller initialises to a copy of the labels, so it
// ends as the swept labels min(labels, row_p, col_p) -- the JAX fold
// min(labels, row_p) then min(., col_p) is the same single minimum. The
// sweep is therefore Jacobi (the TPU route is Gauss-Seidel between
// chunks); sweep counts may differ, the fixpoint does not.
//
// What bounds it on the H100: per pair, D fp32 subtract + fma and one
// compare; the labels are a few bytes per frame. The TPU kept the column
// proposals VMEM-resident; here they cross CTAs through atomics, kept rare:
// a proposal only matters if it is below the frame's current swept label,
// so each chunk's column bounds start at that value in shared memory and
// a warp reduces a column (one __reduce_min_sync) only when a lane can
// improve it. Row proposals stay in a register for the tile.

#include "common.cuh"

namespace {

template <int DT>
__global__ void label_min_bidir_kernel(const float* __restrict__ ct,
                                       int64_t n_pad, int d,
                                       const int* __restrict__ labels,
                                       int n_below, float max_dist2,
                                       const int* __restrict__ ti,
                                       const int* __restrict__ tj,
                                       const int* __restrict__ dirty,
                                       int row_block, int col_block,
                                       int* __restrict__ prop) {
  constexpr int CH = ck::Chunk<DT>::value;
  extern __shared__ int smem_i32[];
  int* s_lab = smem_i32;          // CH
  int* s_best = s_lab + CH;       // CH
  int* s_best0 = s_best + CH;     // CH
  float* ys = reinterpret_cast<float*>(s_best0 + CH);  // d * CH

  const int k = blockIdx.x;
  if (dirty[k] == 0) return;  // neither side changed since the last sweep
  const int i = ti[k];
  const int j = tj[k];

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)i * row_block;
  const int64_t row = row0 + tid;
  const bool row_on = tid < row_block && row < n_below;
  const int64_t colbase = (int64_t)j * col_block;

  ck::RowCoords<DT> x;
  x.load(ct, n_pad, tid < row_block ? row : row0, d);
  const int lab_x = row_on ? labels[row] : 0x7fffffff;
  int my_best = lab_x;

  for (int off = 0; off < col_block; off += CH) {
    const int64_t col0 = colbase + off;
    const int ch = min(CH, col_block - off);
    if (col0 >= n_below) break;
    __syncthreads();
    ck::stage_cols(ys, ct, n_pad, d, col0, ch);
    for (int c = tid; c < ch; c += blockDim.x) {
      const int64_t col = col0 + c;
      const int lab = labels[col];
      // columns past n_below take no proposals: bound them at -1
      const int b = col < n_below ? prop[col] : -1;
      s_lab[c] = lab;
      s_best[c] = s_best0[c] = b;
    }
    __syncthreads();
    for (int c = 0; c < ch; ++c) {
      const float d2 = x.dist2(ys, ch, c, d);
      const bool adj = row_on && d2 < max_dist2 && col0 + c < n_below;
      if (adj) my_best = min(my_best, s_lab[c]);
      const int cand = adj ? lab_x : 0x7fffffff;
      const bool better = cand < s_best[c];
      if (__any_sync(FULL_MASK, better)) {
        const int m = __reduce_min_sync(FULL_MASK, cand);
        if ((tid & 31) == 0) atomicMin(&s_best[c], m);
      }
    }
    __syncthreads();
    for (int c = tid; c < ch; c += blockDim.x) {
      if (s_best[c] < s_best0[c]) atomicMin(&prop[col0 + c], s_best[c]);
    }
  }
  if (row_on && my_best < lab_x) atomicMin(&prop[row], my_best);
}

}  // namespace

extern "C" int ck_label_min_bidir(const float* coords_t, long long n_pad,
                                  int d, const int* labels, int n_below,
                                  float max_dist2, const int* ti,
                                  const int* tj, const int* dirty,
                                  long long n_tiles, int row_block,
                                  int col_block, int* prop, void* stream) {
  if (row_block < 1 || row_block > 1024) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int threads = ck::cta_threads(row_block);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    constexpr int CH = ck::Chunk<DT>::value;
    const size_t smem = (size_t)CH * (3 * sizeof(int)) +
                        (size_t)CH * d * sizeof(float);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(label_min_bidir_kernel<DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    label_min_bidir_kernel<DT><<<(unsigned)n_tiles, threads, smem, st>>>(
        coords_t, (int64_t)n_pad, d, labels, n_below, max_dist2, ti, tj,
        dirty, row_block, col_block, prop);
  });
  return (int)cudaGetLastError();
}
