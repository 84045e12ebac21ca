// Row-side joint nearest-neighbour / nearest-lower-free-energy neighbour
// search over a tile list that holds both orientations (the symmetric
// sweep).
//
// Replaces the TPU kernel clustering_tpu/ops/pallas_kernels.py:
// _nn_sparse_kernel (called through nn_tiles_sparse_cross). Rows come from
// a (D, R_pad) matrix with their own free energies and original ids, columns
// from a (D, N_pad) matrix (the cross form; the single-device path passes
// one matrix twice). A row's candidates are the columns below n_valid with
// 0 < d2 < inf; hd candidates also need strictly lower free energy. Each
// row keeps two lexicographic (d2, original id) minima.
//
// Results fold into the same id-keyed (2, N_pad) buffer of 64-bit keys
// (float_bits(d2) << 32) | original_id as nn_bidir.cu, initialised by the
// caller to KEY_NONE = (bits(+inf) << 32) | INT32_MAX. d2 >= 0 keeps the
// bit order equal to the float order, so atomicMin on the packed key is
// the exact lexicographic minimum in any CTA order, and the band pass and
// phase 2 accumulate into one buffer in any frame order (the TPU path's
// lexicographic merge and unpermute have no counterpart here). A row
// writes at its original id; rows with id INT32_MAX (pads) never write,
// and KEY_NONE is above every finite key, so no index is ever latched at
// infinite distance.
//
// What bounds it on the H100: per pair, D fp32 subtract + fma and two
// compare/select minima on 64-bit keys; every pair is evaluated once per
// orientation. The TPU carried a row block's minima across the sorted
// grid in VMEM; here each thread holds its row's two minima in registers
// for the whole tile and issues at most one atomicMin per side, and the
// column free energies and ids are staged in shared memory beside the
// coordinates.

#include "common.cuh"

namespace {

constexpr unsigned long long KEY_NONE =
    (0x7F800000ull << 32) | 0x7FFFFFFFull;
constexpr int IMAX = 0x7FFFFFFF;

__device__ __forceinline__ unsigned long long make_key(float d2, int oid) {
  return ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)oid;
}

template <int DT>
__global__ void nn_sparse_kernel(const float* __restrict__ rows_t,
                                 int64_t r_pad,
                                 const float* __restrict__ fe_rows,
                                 const int* __restrict__ oid_rows,
                                 const float* __restrict__ cols_t,
                                 int64_t n_pad, int d,
                                 const float* __restrict__ fe_cols,
                                 const int* __restrict__ oid_cols,
                                 int n_valid, const int* __restrict__ ti,
                                 const int* __restrict__ tj, int row_block,
                                 int col_block,
                                 unsigned long long* __restrict__ keys) {
  constexpr int CH = ck::Chunk<DT>::value;
  extern __shared__ float smem_f32[];
  float* s_fe = smem_f32;                             // CH
  int* s_oid = reinterpret_cast<int*>(s_fe + CH);     // CH
  float* ys = reinterpret_cast<float*>(s_oid + CH);   // d * CH

  const int k = blockIdx.x;
  const int j = tj[k];
  if (j < 0) return;

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)ti[k] * row_block;
  const int64_t row = row0 + tid;
  const bool row_on = tid < row_block;
  const int64_t colbase = (int64_t)j * col_block;

  ck::RowCoords<DT> x;
  x.load(rows_t, r_pad, row_on ? row : row0, d);
  const float fe_x = row_on ? fe_rows[row] : __int_as_float(0x7f800000);
  const int oid_x = row_on ? oid_rows[row] : IMAX;
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
      s_oid[c] = oid_cols[col0 + c];
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
  if (oid_x != IMAX) {
    if (my_nh != KEY_NONE) atomicMin(&keys[oid_x], my_nh);
    if (my_hd != KEY_NONE) atomicMin(&keys[n_pad + oid_x], my_hd);
  }
}

}  // namespace

extern "C" int ck_nn_sparse(const float* rows_t, long long r_pad,
                            const float* fe_rows, const int* oid_rows,
                            const float* cols_t, long long n_pad, int d,
                            const float* fe_cols, const int* oid_cols,
                            int n_valid, const int* ti, const int* tj,
                            long long n_tiles, int row_block, int col_block,
                            unsigned long long* keys, void* stream) {
  if (row_block < 1 || row_block > 1024) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int threads = ck::cta_threads(row_block);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    constexpr int CH = ck::Chunk<DT>::value;
    const size_t smem = (size_t)CH * (sizeof(float) + sizeof(int)) +
                        ck::col_smem_bytes(DT, d);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(nn_sparse_kernel<DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    nn_sparse_kernel<DT><<<(unsigned)n_tiles, threads, smem, st>>>(
        rows_t, (int64_t)r_pad, fe_rows, oid_rows, cols_t, (int64_t)n_pad, d,
        fe_cols, oid_cols, n_valid, ti, tj, row_block, col_block, keys);
  });
  return (int)cudaGetLastError();
}
