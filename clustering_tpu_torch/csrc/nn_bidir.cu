// Bidirectional joint nearest-neighbour / nearest-lower-free-energy
// neighbour search over an upper-triangular tile closure.
//
// Replaces the TPU kernel clustering_tpu/ops/pallas_kernels.py:
// _nn_bidir_kernel (called through _nn_bidir_call / nn_tiles_bidir_all).
// Every listed tile is evaluated once and serves both sides: each row
// takes its column candidates and each column its row candidates. For
// every frame two lexicographic (d2, original id) minima are kept: nh over
// all frames with d2 > 0, hd over those with strictly lower free energy.
//
// Results are 64-bit keys (float_bits(d2) << 32) | original_id, indexed by
// ORIGINAL frame id in a (2, N_pad) buffer that the caller initialises to
// KEY_NONE = (bits(+inf) << 32) | INT32_MAX, i.e. "no neighbour" unpacks
// to (inf, IMAX). d2 >= 0 keeps the bit order equal to the float order, so
// atomicMin on the packed key is the exact lexicographic minimum whatever
// the scheduling; only finite candidates ever reach the buffer. Because
// the buffer is keyed by original id, sweeps over different frame orders
// (the band pass and phase 2) accumulate into one buffer with no merge.
//
// What bounds it on the H100: the FP32 pipe, 3 * D flops per pair (D
// subtractions, D fmas). Beside them the pair feeds four (d2, id) minima
// (row nh / hd, column nh / hd): a 64-bit compare and select each, on the
// integer pipe at half the FP32 rate, which bounded the first micro-tiled
// version at ~0.11 of the FP32 bound. The design:
//  - register micro-tiles (common.cuh): a thread holds MT_RM rows for the
//    whole tile and evaluates MT_RM x MT_RN pairs per step, 16 independent
//    fma chains, columns read as one float4 per dimension;
//  - a filter on the FP32 pipe: each row and column carries a threshold
//    T = nextafter(d2 of the larger of its two held keys); a pair can
//    lower a key only if d2 < T, i.e. if d2 - T is negative, so the step
//    ORs the sign words of d2 - T_row per row and of d2 - T_col per column
//    (two subtractions and one OR per pair) and runs the exact update only
//    for the rows and columns whose sign is set: a frame whose keys are
//    still loose costs its own row or column, not the whole step. The
//    held keys are never below the final minima, so the filter drops only
//    pairs that cannot matter;
//  - keys are compared in the shifted domain of common.cuh (shift_key,
//    skey): d2 = 0 never wins, and an infinite or NaN d2 (pads, and the
//    NaN-staged frames outside the sweep) never beats a held minimum;
//  - row minima start from the frame's keys in the buffer, read once per
//    tile, and fold across the MT_TC threads of a row by shuffles at the
//    pass's end: one atomicMin per row and side, only on improvement;
//    the registers this frees let three 256-thread CTAs share an SM
//    for D <= 8 (two above, where the row coordinates need more);
//  - column minima and thresholds live in shared memory for the chunk
//    (read from the buffer once per column and chunk); an exact step
//    lowers them by shared atomicMin, and the chunk's end sends one
//    global atomicMin per improved column;
//  - coordinates, fe and original ids of the next chunk come in by
//    cp.async into a second buffer while the current chunk is computed.
// The distance stays the fma chain from zero in ascending dimension order
// (no tensor cores, no |x|^2 + |y|^2 - 2xy), so the results are bit-equal
// to the plain version and to the Pallas kernel.

#include "common.cuh"

namespace {

using ck::u64;

template <int DT>
__global__ void __launch_bounds__(ck::MT_MAX_TR * ck::MT_TC,
                                  DT >= 1 && DT <= 8 ? 3 : 2)
nn_bidir_kernel(const float* __restrict__ ct, int64_t n_pad, int d,
                const float* __restrict__ fe, const int* __restrict__ oid,
                int n_valid, const int* __restrict__ ti,
                const int* __restrict__ tj, int row_block, int col_block,
                u64* __restrict__ keys) {
  using namespace ck;
  constexpr int CH = MtChunk<DT>::value;
  extern __shared__ u64 smem_u64[];
  u64* s_nh = smem_u64;                                 // CH, running
  u64* s_hd = s_nh + CH;                                // CH
  u64* s_nh0 = s_hd + CH;                               // CH, as read
  u64* s_hd0 = s_nh0 + CH;                              // CH
  float* s_t = reinterpret_cast<float*>(s_hd0 + CH);    // CH, filter
  float* s_fe = s_t + CH;                                // 2 x CH
  int* s_oid = reinterpret_cast<int*>(s_fe + 2 * CH);   // 2 x CH
  float* ys = reinterpret_cast<float*>(s_oid + 2 * CH);  // 2 x d * CH

  const int t = blockIdx.x;
  const int i = ti[t];
  const int j = tj[t];
  if (j < 0) return;
  const int64_t colbase = (int64_t)j * col_block;
  if (colbase >= n_valid) return;
  const int64_t row0 = (int64_t)i * row_block;
  u64* keys_hd = keys + n_pad;

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
    int ox[MT_RM];
    u64 rnh[MT_RM], rhd[MT_RM];
    float t_row[MT_RM];
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const int r = p0 + tr + n_tr * m;
      row[m] = row0 + r;
      ok[m] = r < row_block && row[m] < n_valid;
      fx[m] = ok[m] ? fe[row[m]] : qnan();
      ox[m] = ok[m] ? oid[row[m]] : 0;
      rnh[m] = ok[m] ? shift_key(keys[ox[m]]) : INF0;
      rhd[m] = ok[m] ? shift_key(keys_hd[ox[m]]) : INF0;
      t_row[m] = filter_t(rnh[m], rhd[m]);
    }
    MtRows<DT> x;
    x.load(ct, n_pad, d, row, ok);

    // chunk 0 of this pass
    __syncthreads();  // the previous pass is done with every buffer
    {
      const int ch = min(CH, col_block);
      mt_stage_cols<CH>(ys, ct, n_pad, d, colbase, ch, n_valid);
      for (int c = tid; c < CH; c += blockDim.x) {
        if (c < ch && colbase + c < n_valid) {
          cp_async4(&s_fe[c], &fe[colbase + c]);
          cp_async4(&s_oid[c], &oid[colbase + c]);
        } else {
          s_fe[c] = qnan();
          s_oid[c] = -1;
        }
      }
      cp_async_commit();
    }

    for (int q = 0; q < n_chunks; ++q) {
      const int b = q & 1;
      const int64_t col0 = colbase + (int64_t)q * CH;
      const int ch = min(CH, col_block - q * CH);
      const float* yb = ys + b * d * CH;
      const float* feb = s_fe + b * CH;
      const int* oidb = s_oid + b * CH;
      cp_async_wait_all();
      __syncthreads();  // chunk q staged; chunk q - 1 fully written back
      if (q + 1 < n_chunks) {
        const int nb = b ^ 1;
        const int64_t col1 = col0 + CH;
        const int ch1 = min(CH, col_block - (q + 1) * CH);
        mt_stage_cols<CH>(ys + nb * d * CH, ct, n_pad, d, col1, ch1,
                          n_valid);
        for (int c = tid; c < CH; c += blockDim.x) {
          if (c < ch1 && col1 + c < n_valid) {
            cp_async4(&s_fe[nb * CH + c], &fe[col1 + c]);
            cp_async4(&s_oid[nb * CH + c], &oid[col1 + c]);
          } else {
            s_fe[nb * CH + c] = qnan();
            s_oid[nb * CH + c] = -1;
          }
        }
        cp_async_commit();
      }
      // the chunk's columns' current keys; 0 (nothing beats it) outside
      for (int c = tid; c < CH; c += blockDim.x) {
        const int o = oidb[c];
        const u64 kn = o >= 0 ? shift_key(keys[o]) : 0ull;
        const u64 kh = o >= 0 ? shift_key(keys_hd[o]) : 0ull;
        s_nh[c] = s_nh0[c] = kn;
        s_hd[c] = s_hd0[c] = kh;
        s_t[c] = filter_t(kn, kh);
      }
      __syncthreads();

      for (int cbase = 0; cbase < ch; cbase += MT_STEP) {
        const int c0 = cbase + MT_RN * tc;
        const float4 t4 = *reinterpret_cast<const float4*>(&s_t[c0]);
        const float t_col[MT_RN] = {t4.x, t4.y, t4.z, t4.w};
        float d2[MT_RM][MT_RN];
        mt_dist2<DT, CH>(x, yb, d, c0, d2);
        // filter: the sign bit is set where d2 is below a row's (near_r)
        // or a column's (near_c) threshold
        unsigned near_r[MT_RM], near_c[MT_RN];
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) near_r[m] = 0;
#pragma unroll
        for (int n = 0; n < MT_RN; ++n) near_c[n] = 0;
#pragma unroll
        for (int m = 0; m < MT_RM; ++m)
#pragma unroll
          for (int n = 0; n < MT_RN; ++n) {
            near_r[m] |= __float_as_uint(d2[m][n] - t_row[m]);
            near_c[n] |= __float_as_uint(d2[m][n] - t_col[n]);
          }
        if ((int)(near_r[0] | near_r[1] | near_r[2] | near_r[3] | near_c[0] |
                  near_c[1] | near_c[2] | near_c[3]) >= 0)
          continue;

        // exact updates, only for the rows and columns the filter flagged
        const float4 fy4 = *reinterpret_cast<const float4*>(&feb[c0]);
        const float fy[MT_RN] = {fy4.x, fy4.y, fy4.z, fy4.w};
#pragma unroll
        for (int m = 0; m < MT_RM; ++m) {
          if ((int)near_r[m] >= 0) continue;
          const int4 oy4 = *reinterpret_cast<const int4*>(&oidb[c0]);
          const int oy[MT_RN] = {oy4.x, oy4.y, oy4.z, oy4.w};
#pragma unroll
          for (int n = 0; n < MT_RN; ++n) {
            const u64 kr = skey(d2[m][n], oy[n]);
            rnh[m] = kr < rnh[m] ? kr : rnh[m];
            rhd[m] = (fy[n] < fx[m] && kr < rhd[m]) ? kr : rhd[m];
          }
          t_row[m] = filter_t(rnh[m], rhd[m]);
        }
#pragma unroll
        for (int n = 0; n < MT_RN; ++n) {
          if ((int)near_c[n] >= 0) continue;
          const u64 nh0 = s_nh[c0 + n], hd0 = s_hd[c0 + n];
          u64 nh = nh0, hd = hd0;
#pragma unroll
          for (int m = 0; m < MT_RM; ++m) {
            const u64 kc = skey(d2[m][n], ox[m]);
            nh = kc < nh ? kc : nh;
            hd = (fx[m] < fy[n] && kc < hd) ? kc : hd;
          }
          if (nh < nh0) atomicMin(&s_nh[c0 + n], nh);
          if (hd < hd0) atomicMin(&s_hd[c0 + n], hd);
          if (nh < nh0 || hd < hd0)
            atomicMin(reinterpret_cast<int*>(&s_t[c0 + n]),
                      __float_as_int(filter_t(nh, hd)));
        }
      }
      __syncthreads();
      for (int c = tid; c < ch; c += blockDim.x) {
        if (s_nh[c] < s_nh0[c]) atomicMin(&keys[oidb[c]], s_nh[c] + ONE_HI);
        if (s_hd[c] < s_hd0[c])
          atomicMin(&keys_hd[oidb[c]], s_hd[c] + ONE_HI);
      }
    }

    // rows: fold across the MT_TC threads of each row
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const u64 nh = warp_min8(rnh[m], mask);
      const u64 hd = warp_min8(rhd[m], mask);
      // the buffer is read again rather than held in registers: an
      // atomic only where the row still improves it
      if (tc == 0 && ok[m]) {
        if (nh < shift_key(keys[ox[m]])) atomicMin(&keys[ox[m]], nh + ONE_HI);
        if (hd < shift_key(keys_hd[ox[m]]))
          atomicMin(&keys_hd[ox[m]], hd + ONE_HI);
      }
    }
  }
}

}  // namespace

extern "C" int ck_nn_bidir(const float* coords_t, long long n_pad, int d,
                           const float* fe, const int* oid, int n_valid,
                           const int* ti, const int* tj, long long n_tiles,
                           int row_block, int col_block,
                           unsigned long long* keys, void* stream) {
  if (row_block < 1 || row_block > 1024 || col_block < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int threads = ck::mt_thread_rows(row_block) * ck::MT_TC;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    constexpr int CH = ck::MtChunk<DT>::value;
    const size_t smem = (size_t)CH * (4 * sizeof(u64) + sizeof(float) +
                                      2 * (sizeof(float) + sizeof(int))) +
                        (size_t)2 * CH * d * sizeof(float);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(nn_bidir_kernel<DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    nn_bidir_kernel<DT><<<(unsigned)n_tiles, threads, smem, st>>>(
        coords_t, (int64_t)n_pad, d, fe, oid, n_valid, ti, tj, row_block,
        col_block, keys);
  });
  return (int)cudaGetLastError();
}
