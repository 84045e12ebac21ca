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
//  - register micro-tiles (common.cuh): a thread holds MT_RM rows for the
//    pass and evaluates MT_RM x MT_RN pairs per step, 16 independent fma
//    chains, columns read as one float4 per dimension;
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

using ck::u64;

// Start the copy of chunk columns [col0, col0 + ch) into buffer `buf`:
// coordinates, fe and original ids (the ids bit for bit through the float
// stager; a NaN-staged column's id is never read as a candidate's).
template <int CH>
__device__ __forceinline__ void stage_chunk(
    float* ys, float* s_fe, int* s_oid, int buf,
    const float* __restrict__ cols_t, int64_t n_pad, int d,
    const float* __restrict__ fe_cols, const int* __restrict__ orig_ids,
    int64_t col0, int ch, int n_valid) {
  ck::mt_stage_cols16<CH>(ys + buf * d * CH, cols_t, n_pad, d, col0, ch,
                          n_valid);
  ck::mt_stage_cols16<CH>(s_fe + buf * CH, fe_cols, n_pad, 1, col0, ch,
                          n_valid);
  ck::mt_stage_cols16<CH>(reinterpret_cast<float*>(s_oid + buf * CH),
                          reinterpret_cast<const float*>(orig_ids), n_pad, 1,
                          col0, ch, n_valid);
  ck::cp_async_commit();
}

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
                u64* __restrict__ keys) {
  using namespace ck;
  constexpr int CH = MtChunk<DT>::value;
  extern __shared__ __align__(16) float smem_f32[];
  float* s_fe = smem_f32;                                // 2 x CH
  int* s_oid = reinterpret_cast<int*>(s_fe + 2 * CH);    // 2 x CH
  float* ys = reinterpret_cast<float*>(s_oid + 2 * CH);  // 2 x d * CH

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
  const int64_t row0 = i * row_block;
  u64* keys_hd = keys + r_pad;

  const int tid = threadIdx.x;
  const int tc = tid % MT_TC;
  const int tr = tid / MT_TC;
  const int n_tr = blockDim.x / MT_TC;
  const int rows_per_pass = n_tr * MT_RM;
  const unsigned mask = mt_warp_mask();
  const int n_chunks =
      (int)((min((int64_t)col_block, n_valid - colbase) + CH - 1) / CH);

  for (int p0 = 0; p0 < row_block; p0 += rows_per_pass) {
    int64_t row[MT_RM];
    bool ok[MT_RM];
    float fx[MT_RM];
    u64 rnh[MT_RM], rhd[MT_RM];
    float t_row[MT_RM];
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const int r = p0 + tr + n_tr * m;
      row[m] = row0 + r;
      ok[m] = r < row_block;
      fx[m] = ok[m] ? fe_rows[row[m]] : qnan();
      rnh[m] = ok[m] ? shift_key(keys[row[m]]) : INF0;
      rhd[m] = ok[m] ? shift_key(keys_hd[row[m]]) : INF0;
      t_row[m] = filter_t(rnh[m], rhd[m]);
    }
    MtRows<DT> x;
    x.load(rows_t, r_pad, d, row, ok);

    __syncthreads();  // the previous pass is done with both buffers
    stage_chunk<CH>(ys, s_fe, s_oid, 0, cols_t, n_pad, d, fe_cols, orig_ids,
                    colbase, min(CH, col_block), n_valid);

    for (int q = 0; q < n_chunks; ++q) {
      const int b = q & 1;
      const int ch = min(CH, col_block - q * CH);
      const float* yb = ys + b * d * CH;
      const float* feb = s_fe + b * CH;
      const int* oidb = s_oid + b * CH;
      cp_async_wait_all();
      __syncthreads();  // chunk q staged; chunk q - 1 computed
      if (q + 1 < n_chunks)
        stage_chunk<CH>(ys, s_fe, s_oid, b ^ 1, cols_t, n_pad, d, fe_cols,
                        orig_ids, colbase + (int64_t)(q + 1) * CH,
                        min(CH, col_block - (q + 1) * CH), n_valid);

      for (int cbase = 0; cbase < ch; cbase += MT_STEP) {
        const int c0 = cbase + MT_RN * tc;
        float d2[MT_RM][MT_RN];
        mt_dist2<DT, CH>(x, yb, d, c0, d2);
        // filter: the sign bit is set where d2 is below a row's threshold
        unsigned near[MT_RM];
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) {
          near[m] = 0;
#pragma unroll
          for (int n = 0; n < MT_RN; ++n)
            near[m] |= __float_as_uint(d2[m][n] - t_row[m]);
        }
        if ((int)(near[0] | near[1] | near[2] | near[3]) >= 0) continue;

        // exact updates, only for the rows the filter flagged
        const float4 fy4 = *reinterpret_cast<const float4*>(&feb[c0]);
        const float fy[MT_RN] = {fy4.x, fy4.y, fy4.z, fy4.w};
        const int4 oy4 = *reinterpret_cast<const int4*>(&oidb[c0]);
        const int oy[MT_RN] = {oy4.x, oy4.y, oy4.z, oy4.w};
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) {
          if ((int)near[m] >= 0) continue;
#pragma unroll
          for (int n = 0; n < MT_RN; ++n) {
            const u64 kr = skey(d2[m][n], oy[n]);
            rnh[m] = kr < rnh[m] ? kr : rnh[m];
            rhd[m] = (fy[n] < fx[m] && kr < rhd[m]) ? kr : rhd[m];
          }
          t_row[m] = filter_t(rnh[m], rhd[m]);
        }
      }
    }

    // rows: fold across the MT_TC threads of each row; an atomic only
    // where the row still improves the buffer
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const u64 nh = warp_min8(rnh[m], mask);
      const u64 hd = warp_min8(rhd[m], mask);
      if (tc == 0 && ok[m]) {
        if (nh < shift_key(keys[row[m]]))
          atomicMin(&keys[row[m]], nh + ONE_HI);
        if (hd < shift_key(keys_hd[row[m]]))
          atomicMin(&keys_hd[row[m]], hd + ONE_HI);
      }
    }
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
  const int threads = ck::mt_thread_rows(row_block) * ck::MT_TC;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    constexpr int CH = ck::MtChunk<DT>::value;
    const size_t smem =
        (size_t)2 * CH * (sizeof(float) + sizeof(int) + d * sizeof(float));
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
