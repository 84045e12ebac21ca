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
// What bounds it on the H100: the FP32 pipe, 3 * D flops per pair (D
// subtractions, D fmas), beside one compare and two label minima per
// pair; the labels are a few bytes per frame. The design (register
// micro-tiles of common.cuh, as nn_bidir.cu):
//  - a thread holds MT_RM rows (coordinates and labels) for the whole
//    tile and evaluates MT_RM x MT_RN pairs per step; rows and columns at
//    or past n_below are staged as NaN, so d2 < max_dist2 alone decides
//    adjacency;
//  - a step whose pairs cannot lower any bound is skipped before its
//    distances: when the smallest column label is at least the largest
//    row bound and the smallest row label at least the largest column
//    bound (the usual case inside a converged component), no adjacency
//    can change anything, so the exact result needs no d2 there;
//  - row proposals stay in registers for the tile and fold across the
//    MT_TC threads of a row by shuffles: one atomicMin per row, only
//    where it beats the row's label;
//  - column bounds start, each step, from the chunk's running bounds in
//    shared memory (the swept labels, read once per column and chunk) and
//    go back by a shared atomicMin only where the step lowered them; at
//    the chunk's end one global atomicMin per lowered column;
//  - the next chunk's coordinates and labels come in by cp.async into a
//    second buffer while the current chunk is computed.
// The distance is the fma chain from zero in ascending dimension order,
// bit-equal to the plain version, so adjacency and the fixpoint are
// exactly the JAX package's.

#include "common.cuh"

namespace {

constexpr int IMAX = 0x7fffffff;

template <int DT>
__global__ void __launch_bounds__(ck::MT_MAX_TR * ck::MT_TC)
label_min_bidir_kernel(const float* __restrict__ ct, int64_t n_pad, int d,
                       const int* __restrict__ labels, int n_below,
                       float max_dist2, const int* __restrict__ ti,
                       const int* __restrict__ tj,
                       const int* __restrict__ dirty, int row_block,
                       int col_block, int* __restrict__ prop) {
  using namespace ck;
  constexpr int CH = MtChunk<DT>::value;
  extern __shared__ int smem_i32[];
  int* s_best = smem_i32;                              // CH, running
  int* s_best0 = s_best + CH;                          // CH, as read
  int* s_lab = s_best0 + CH;                           // 2 x CH
  float* ys = reinterpret_cast<float*>(s_lab + 2 * CH);  // 2 x d * CH

  const int t = blockIdx.x;
  if (dirty[t] == 0) return;  // neither side changed since the last sweep
  const int64_t colbase = (int64_t)tj[t] * col_block;
  if (colbase >= n_below) return;
  const int64_t row0 = (int64_t)ti[t] * row_block;

  const int tid = threadIdx.x;
  const int tc = tid % MT_TC;
  const int tr = tid / MT_TC;
  const int n_tr = blockDim.x / MT_TC;
  const int rows_per_pass = n_tr * MT_RM;
  const unsigned mask = mt_warp_mask();
  const int n_chunks =
      (int)((min((int64_t)col_block, n_below - colbase) + CH - 1) / CH);

  for (int p0 = 0; p0 < row_block; p0 += rows_per_pass) {
    int64_t row[MT_RM];
    bool ok[MT_RM];
    // rows outside the sweep: label IMAX (never proposed), bound -1
    // (never lowered), so they never keep a step from being skipped
    int lx[MT_RM], rbest[MT_RM];
    int lx_min = IMAX;
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const int r = p0 + tr + n_tr * m;
      row[m] = row0 + r;
      ok[m] = r < row_block && row[m] < n_below;
      lx[m] = ok[m] ? labels[row[m]] : IMAX;
      rbest[m] = ok[m] ? lx[m] : -1;
      lx_min = min(lx_min, lx[m]);
    }
    MtRows<DT> x;
    x.load(ct, n_pad, d, row, ok);

    __syncthreads();  // the previous pass is done with every buffer
    {
      const int ch = min(CH, col_block);
      mt_stage_cols<CH>(ys, ct, n_pad, d, colbase, ch, n_below);
      for (int c = tid; c < CH; c += blockDim.x) {
        if (c < ch && colbase + c < n_below)
          cp_async4(&s_lab[c], &labels[colbase + c]);
        else
          s_lab[c] = IMAX;
      }
      cp_async_commit();
    }

    for (int q = 0; q < n_chunks; ++q) {
      const int b = q & 1;
      const int64_t col0 = colbase + (int64_t)q * CH;
      const int ch = min(CH, col_block - q * CH);
      const float* yb = ys + b * d * CH;
      const int* labb = s_lab + b * CH;
      cp_async_wait_all();
      __syncthreads();  // chunk q staged; chunk q - 1 fully written back
      if (q + 1 < n_chunks) {
        const int nb = b ^ 1;
        const int64_t col1 = col0 + CH;
        const int ch1 = min(CH, col_block - (q + 1) * CH);
        mt_stage_cols<CH>(ys + nb * d * CH, ct, n_pad, d, col1, ch1,
                          n_below);
        for (int c = tid; c < CH; c += blockDim.x) {
          if (c < ch1 && col1 + c < n_below)
            cp_async4(&s_lab[nb * CH + c], &labels[col1 + c]);
          else
            s_lab[nb * CH + c] = IMAX;
        }
        cp_async_commit();
      }
      // the chunk's columns' swept labels; -1 (nothing beats it) outside
      for (int c = tid; c < CH; c += blockDim.x) {
        const int v = (c < ch && col0 + c < n_below) ? prop[col0 + c] : -1;
        s_best[c] = s_best0[c] = v;
      }
      __syncthreads();

      for (int cbase = 0; cbase < ch; cbase += MT_STEP) {
        const int c0 = cbase + MT_RN * tc;
        const int4 ly4 = *reinterpret_cast<const int4*>(&labb[c0]);
        const int4 cb4 = *reinterpret_cast<const int4*>(&s_best[c0]);
        const int ly[MT_RN] = {ly4.x, ly4.y, ly4.z, ly4.w};
        int cb[MT_RN] = {cb4.x, cb4.y, cb4.z, cb4.w};
        // no proposal of this step can lower a bound: skip its distances
        int rb_max = rbest[0], ly_min = ly[0], cb_max = cb[0];
#pragma unroll
        for (int m = 1; m < MT_RM; ++m) rb_max = max(rb_max, rbest[m]);
#pragma unroll
        for (int n = 1; n < MT_RN; ++n) {
          ly_min = min(ly_min, ly[n]);
          cb_max = max(cb_max, cb[n]);
        }
        if (ly_min >= rb_max && lx_min >= cb_max) continue;
        const int cb0[MT_RN] = {cb[0], cb[1], cb[2], cb[3]};
        float d2[MT_RM][MT_RN];
        mt_dist2<DT, CH>(x, yb, d, c0, d2);
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) {
#pragma unroll
          for (int n = 0; n < MT_RN; ++n) {
            const bool adj = d2[m][n] < max_dist2;
            rbest[m] = adj ? min(rbest[m], ly[n]) : rbest[m];
            cb[n] = adj ? min(cb[n], lx[m]) : cb[n];
          }
        }
#pragma unroll
        for (int n = 0; n < MT_RN; ++n)
          if (cb[n] < cb0[n]) atomicMin(&s_best[c0 + n], cb[n]);
      }
      __syncthreads();
      for (int c = tid; c < ch; c += blockDim.x)
        if (s_best[c] < s_best0[c]) atomicMin(&prop[col0 + c], s_best[c]);
    }

#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const int best = warp_min8(rbest[m], mask);
      if (tc == 0 && ok[m] && best < lx[m]) atomicMin(&prop[row[m]], best);
    }
  }
}

}  // namespace

extern "C" int ck_label_min_bidir(const float* coords_t, long long n_pad,
                                  int d, const int* labels, int n_below,
                                  float max_dist2, const int* ti,
                                  const int* tj, const int* dirty,
                                  long long n_tiles, int row_block,
                                  int col_block, int* prop, void* stream) {
  if (row_block < 1 || row_block > 1024 || col_block < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int threads = ck::mt_thread_rows(row_block) * ck::MT_TC;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    constexpr int CH = ck::MtChunk<DT>::value;
    const size_t smem = (size_t)CH * 4 * sizeof(int) +
                        (size_t)2 * CH * d * sizeof(float);
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
