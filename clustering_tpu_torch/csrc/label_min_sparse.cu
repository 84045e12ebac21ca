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
// afterwards; the kernel writes raw proposals (INT32_MAX where a row has
// no adjacent column) and never reads the row's own label. Labels are
// read, never written, so one launch over the flat list is a Jacobi sweep
// (the TPU route folds chunks Gauss-Seidel: sweep counts may differ, the
// fixpoint does not).
//
// What bounds it on the H100: the FP32 pipe, 3 * D flops per pair (D
// subtractions, D fmas); every pair is evaluated once per orientation. A
// compare, min and select per pair on the integer pipe (half the FP32
// rate) held the first micro-tiled build at 0.46 of that bound (NVIDIA
// H100 80GB HBM3, 700 W). The design is label_min_bidir.cu's row side on
// the register micro-tiles of common.cuh:
//  - a thread holds MT_RM rows (coordinates in registers, a running bound
//    each) for the pass and evaluates up to MT_RM x MT_RN pairs per step,
//    the step's columns read as one float4 per dimension; rows
//    and columns at or past n_below are outside the sweep (rows: bound -1,
//    never written; columns: staged as NaN coordinates with label
//    INT32_MAX), so d2 < max_dist2 alone decides adjacency;
//  - a row's bound starts from the proposal buffer, read at each pass
//    start (INT32_MAX before any tile of the row has written; never below
//    the final proposal, so the result is exact in any CTA order);
//  - work a step's pairs cannot need is skipped before its distances: the
//    whole step when the smallest staged column label is at least the
//    largest bound of the thread's rows (the usual case inside a converged
//    component once a row holds its component's label), else each row
//    whose bound is at most that label;
//  - adjacency is rare (0.04 % of the evaluated pairs on the 2^20 path),
//    so a row's step takes the compare, min and select of the exact update
//    only when the sign of d2 - max_dist2, ORed over its columns on the
//    FP32 pipe, says that one of them is adjacent;
//  - rows fold across the MT_TC threads of a row by shuffles at the pass's
//    end: one atomicMin per row, only where it lowers what the buffer
//    holds;
//  - 512-column chunks of coordinates and labels double-buffered by
//    16-byte cp.async.
// The wrapper (ops/kernels.py) runs the list in waves by distance from
// each row block's diagonal column block (kernels.wave_order), so that
// most tiles start from bounds that earlier tiles of their rows wrote.
// The distance is the fma chain from zero in ascending dimension order,
// bit-equal to the plain version, so adjacency and the fixpoint are
// exactly the JAX package's.
//
// Built with -DCK_STEP_STATS (a measurement build only, wave_ab.py), the
// kernel also counts, read and zeroed by ck_label_min_sparse_step_stats:
// the thread steps it saw, the ones it skipped, the ones skipped by their
// whole warp (only those save time), and the adjacent pairs among the
// evaluated ones.

#include "common.cuh"

namespace {

constexpr int IMAX = 0x7FFFFFFF;

#ifdef CK_STEP_STATS
// thread steps seen, skipped, skipped by the whole warp; adjacent pairs
__device__ unsigned long long g_steps[4];
#endif

template <int CH>
__device__ __forceinline__ void stage_chunk(
    float* ys, int* s_lab, int buf, const float* __restrict__ cols_t,
    int64_t n_pad, int d, const int* __restrict__ labels, int64_t col0,
    int ch, int n_below) {
  ck::mt_stage_cols16<CH>(ys + buf * d * CH, cols_t, n_pad, d, col0, ch,
                          n_below);
  ck::mt_stage_cols16<CH>(reinterpret_cast<float*>(s_lab + buf * CH),
                          reinterpret_cast<const float*>(labels), n_pad, 1,
                          col0, ch, n_below, __int_as_float(IMAX));
  ck::cp_async_commit();
}

template <int DT>
__global__ void __launch_bounds__(ck::MT_MAX_TR * ck::MT_TC)
label_min_sparse_kernel(const float* __restrict__ rows_t, int64_t r_pad,
                        const float* __restrict__ cols_t, int64_t n_pad,
                        int d, const int* __restrict__ labels, int n_below,
                        float max_dist2, const int* __restrict__ ti,
                        const int* __restrict__ tj, int row_block_offset,
                        const int* __restrict__ dirty, int row_block,
                        int col_block, int* __restrict__ prop) {
  using namespace ck;
  constexpr int CH = MtChunk<DT>::value;
  extern __shared__ __align__(16) float smem_f32[];
  int* s_lab = reinterpret_cast<int*>(smem_f32);         // 2 x CH
  float* ys = reinterpret_cast<float*>(s_lab + 2 * CH);  // 2 x d * CH

  const int k = blockIdx.x;
  const int j = tj[k];
  // no-op pad, or the column block's labels did not change
  if (j < 0 || dirty[j] == 0) return;
  const int64_t grow0 = ((int64_t)row_block_offset + ti[k]) * row_block;
  if (grow0 >= n_below) return;  // every row of the tile is above n_below
  const int64_t colbase = (int64_t)j * col_block;
  if (colbase >= n_below) return;  // every column too
  const int64_t row0 = (int64_t)ti[k] * row_block;

  const int tid = threadIdx.x;
  const int tc = tid % MT_TC;
  const int tr = tid / MT_TC;
  const int n_tr = blockDim.x / MT_TC;
  const int rows_per_pass = n_tr * MT_RM;
  const unsigned mask = mt_warp_mask();
  const int n_chunks =
      (int)((min((int64_t)col_block, n_below - colbase) + CH - 1) / CH);
#ifdef CK_STEP_STATS
  unsigned long long st[4] = {0, 0, 0, 0};
#endif

  for (int p0 = 0; p0 < row_block; p0 += rows_per_pass) {
    int64_t row[MT_RM];
    bool ok[MT_RM];
    int rbest[MT_RM];
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const int r = p0 + tr + n_tr * m;
      row[m] = row0 + r;
      ok[m] = r < row_block && grow0 + r < n_below;
      // rows outside the sweep: bound -1, never lowered, never a reason
      // to evaluate a step
      rbest[m] = ok[m] ? prop[row[m]] : -1;
    }
    MtRows<DT> x;
    x.load(rows_t, r_pad, d, row, ok);

    __syncthreads();  // the previous pass is done with both buffers
    stage_chunk<CH>(ys, s_lab, 0, cols_t, n_pad, d, labels, colbase,
                    min(CH, col_block), n_below);

    for (int q = 0; q < n_chunks; ++q) {
      const int b = q & 1;
      const int ch = min(CH, col_block - q * CH);
      const float* yb = ys + b * d * CH;
      const int* labb = s_lab + b * CH;
      cp_async_wait_all();
      __syncthreads();  // chunk q staged; chunk q - 1 computed
      if (q + 1 < n_chunks)
        stage_chunk<CH>(ys, s_lab, b ^ 1, cols_t, n_pad, d, labels,
                        colbase + (int64_t)(q + 1) * CH,
                        min(CH, col_block - (q + 1) * CH), n_below);

      for (int cbase = 0; cbase < ch; cbase += MT_STEP) {
        const int c0 = cbase + MT_RN * tc;
        const int4 ly4 = *reinterpret_cast<const int4*>(&labb[c0]);
        const int ly[MT_RN] = {ly4.x, ly4.y, ly4.z, ly4.w};
        // no proposal of this step can lower a bound: skip its distances
        int rb_max = rbest[0], ly_min = ly[0];
#pragma unroll
        for (int m = 1; m < MT_RM; ++m) rb_max = max(rb_max, rbest[m]);
#pragma unroll
        for (int n = 1; n < MT_RN; ++n) ly_min = min(ly_min, ly[n]);
#ifdef CK_STEP_STATS
        ++st[0];
        st[1] += ly_min >= rb_max;
        st[2] += __all_sync(mask, ly_min >= rb_max);
#endif
        if (ly_min >= rb_max) continue;
        // the step's columns, one float4 per dimension: in registers for
        // D <= 8, from shared memory per row above (the registers would
        // cost CTAs per SM there)
        constexpr bool Y_REG = DT >= 1 && DT <= 8;
        float4 y4[Y_REG ? DT : 1];
        if constexpr (Y_REG) {
#pragma unroll
          for (int k = 0; k < DT; ++k)
            y4[k] = *reinterpret_cast<const float4*>(&yb[k * CH + c0]);
        }
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) {
          if (ly_min >= rbest[m]) continue;  // no label here lowers row m
          float d2[MT_RN] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int k = 0; k < (DT > 0 ? DT : d); ++k) {
            float4 yk;
            if constexpr (Y_REG)
              yk = y4[k];
            else
              yk = *reinterpret_cast<const float4*>(&yb[k * CH + c0]);
            const float xm = x.get(m, k);
            const float y[MT_RN] = {yk.x, yk.y, yk.z, yk.w};
#pragma unroll
            for (int n = 0; n < MT_RN; ++n) {
              const float diff = xm - y[n];
              d2[n] = __fmaf_rn(diff, diff, d2[n]);
            }
          }
          // filter on the FP32 pipe: the sign of d2 - max_dist2 is set
          // exactly where d2 < max_dist2 (the difference of two floats
          // rounds to zero only when they are equal; NaN and inf d2 give
          // a positive result)
          unsigned near = 0;
#pragma unroll
          for (int n = 0; n < MT_RN; ++n)
            near |= __float_as_uint(d2[n] - max_dist2);
          if ((int)near >= 0) continue;
#pragma unroll
          for (int n = 0; n < MT_RN; ++n) {
            rbest[m] = d2[n] < max_dist2 ? min(rbest[m], ly[n]) : rbest[m];
#ifdef CK_STEP_STATS
            st[3] += d2[n] < max_dist2;
#endif
          }
        }
      }
    }

    // rows: fold across the MT_TC threads of each row; an atomic only
    // where the row lowers what the buffer holds now
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const int best = warp_min8(rbest[m], mask);
      if (tc == 0 && ok[m] && best < prop[row[m]])
        atomicMin(&prop[row[m]], best);
    }
  }
#ifdef CK_STEP_STATS
#pragma unroll
  for (int i = 0; i < 4; ++i) atomicAdd(&g_steps[i], st[i]);
#endif
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
  if (row_block < 1 || row_block > 1024 || col_block < 1 ||
      n_tiles > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int threads = ck::mt_thread_rows(row_block) * ck::MT_TC;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    constexpr int CH = ck::MtChunk<DT>::value;
    const size_t smem = (size_t)2 * CH * (sizeof(int) + d * sizeof(float));
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

#ifdef CK_STEP_STATS
// Copy the counters of every launch since the last call into out[4] and
// zero them; synchronises with the device.
extern "C" int ck_label_min_sparse_step_stats(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_steps, sizeof(g_steps));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_steps, zero, sizeof(g_steps));
}
#endif
