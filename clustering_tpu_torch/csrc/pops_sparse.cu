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
// rmask 0 are no-ops.
//
// What bounds it on the H100: per pair, D fp32 subtract + fma and one
// compare + add per admitted radius, with the columns broadcast from
// shared memory; every pair is evaluated once per orientation, so twice
// per unordered pair where the bidirectional kernel evaluates it once.
// The TPU wrote a row block's counts on its first visit and relied on a
// row-sorted list run in order; CTAs run in any order, so each thread keeps
// its row's counts in registers for the whole tile and adds them to global
// memory with one atomicAdd per row and radius. Nothing crosses CTAs
// otherwise.

#include "common.cuh"

namespace {

constexpr int MAX_R = 8;  // radii per launch; the wrapper groups larger sets

template <int DT>
__global__ void pops_sparse_kernel(const float* __restrict__ rows_t,
                                   int64_t r_pad,
                                   const float* __restrict__ cols_t,
                                   int64_t n_pad, int d,
                                   const float* __restrict__ radii2,
                                   int n_radii, int n_valid,
                                   const int* __restrict__ ti,
                                   const int* __restrict__ tj,
                                   const int* __restrict__ rmask,
                                   int row_block, int col_block,
                                   int* __restrict__ out) {
  constexpr int CH = ck::Chunk<DT>::value;
  extern __shared__ float ys[];  // d * CH

  const int k = blockIdx.x;
  const int j = tj[k];
  const int rm = rmask[k];
  if (j < 0 || rm == 0) return;  // no-op pad, or no radius admissible

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)ti[k] * row_block;
  const int64_t row = row0 + tid;
  const bool row_on = tid < row_block;
  const int64_t colbase = (int64_t)j * col_block;

  float r2[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) r2[r] = r < n_radii ? radii2[r] : -1.0f;

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
        if ((rm >> r) & 1) cnt[r] += d2 <= r2[r];
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

extern "C" int ck_pops_sparse(const float* rows_t, long long r_pad,
                              const float* cols_t, long long n_pad, int d,
                              const float* radii2, int n_radii, int n_valid,
                              const int* ti, const int* tj, const int* rmask,
                              long long n_tiles, int row_block, int col_block,
                              int* out, void* stream) {
  if (n_radii < 1 || n_radii > MAX_R || row_block < 1 || row_block > 1024)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int threads = ck::cta_threads(row_block);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    const size_t smem = ck::col_smem_bytes(DT, d);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(pops_sparse_kernel<DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    pops_sparse_kernel<DT><<<(unsigned)n_tiles, threads, smem, st>>>(
        rows_t, (int64_t)r_pad, cols_t, (int64_t)n_pad, d, radii2, n_radii,
        n_valid, ti, tj, rmask, row_block, col_block, out);
  });
  return (int)cudaGetLastError();
}
