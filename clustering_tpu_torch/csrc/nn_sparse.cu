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
// reads and writes at its original id; rows with id INT32_MAX (pads)
// neither read nor write, and KEY_NONE is above every finite key, so no
// index is ever latched at infinite distance.
//
// What bounds it on the H100: the FP32 pipe, 3 * D flops per pair of a
// listed tile (D subtractions, D fmas); every pair is evaluated once per
// orientation. Beside them each pair would feed two (d2, id) minima, a
// 64-bit compare and select each on the integer pipe at half the FP32
// rate, which held the one-thread-per-row version at 0.17 of the FP32
// bound. The design is nn_tiles.cu's, driven by the tile list: one CTA per
// entry runs ck::nn_cell (common.cuh) keyed by original id --
//  - register micro-tiles: a thread holds MT_RM rows for the pass and
//    evaluates MT_RM x MT_RN pairs per step, columns read as one float4
//    per dimension;
//  - the exact filter on the FP32 pipe (sign of d2 - nextafter(d2 of the
//    larger held key)), with the exact shifted-key updates only for the
//    rows it flags;
//  - row keys read from the buffer at each pass start. Phase 2 of the
//    engine's NN search runs after the band pass, so its rows start from
//    near-final keys and the filter drops nearly every pair; a held key is
//    never below the final minimum, so this is exact in any order;
//  - one atomicMin per row and side at the pass's end, only where the
//    folded key beats the buffer;
//  - 512-column chunks of coordinates, fe and ids double-buffered by
//    16-byte cp.async, columns at or past n_valid staged as NaN.
// The wrapper (ops/kernels.py) runs the list in waves by distance from
// each row block's diagonal column block (kernels.wave_order), so that a
// row block's later tiles find the keys its diagonal tiles wrote; the
// results do not depend on the order.
// The distance stays the fma chain from zero in ascending dimension order,
// bit-equal to the plain version and to the Pallas kernel.

#include "common.cuh"

namespace {

template <int DT>
__global__ void __launch_bounds__(ck::MT_MAX_TR * ck::MT_TC,
                                  DT >= 1 && DT <= 8 ? 3 : 2)
nn_sparse_kernel(const float* __restrict__ rows_t, int64_t r_pad,
                 const float* __restrict__ fe_rows,
                 const int* __restrict__ oid_rows,
                 const float* __restrict__ cols_t, int64_t n_pad, int d,
                 const float* __restrict__ fe_cols,
                 const int* __restrict__ oid_cols, int n_valid,
                 const int* __restrict__ ti, const int* __restrict__ tj,
                 int row_block, int col_block, ck::u64* __restrict__ keys) {
  extern __shared__ __align__(16) float smem_f32[];
  const int k = blockIdx.x;
  const int j = tj[k];
  if (j < 0) return;  // no-op pad
  const int64_t colbase = (int64_t)j * col_block;
  if (colbase >= n_valid) return;  // no column below n_valid
  // keys by original id: the (2, N_pad) buffer
  ck::nn_cell<DT, true>(smem_f32, rows_t, r_pad, fe_rows, oid_rows, cols_t,
                        n_pad, d, fe_cols, oid_cols, n_valid,
                        (int64_t)ti[k] * row_block, colbase, row_block,
                        col_block, keys, n_pad);
}

}  // namespace

extern "C" int ck_nn_sparse(const float* rows_t, long long r_pad,
                            const float* fe_rows, const int* oid_rows,
                            const float* cols_t, long long n_pad, int d,
                            const float* fe_cols, const int* oid_cols,
                            int n_valid, const int* ti, const int* tj,
                            long long n_tiles, int row_block, int col_block,
                            unsigned long long* keys, void* stream) {
  if (row_block < 1 || row_block > 1024 || col_block < 1 ||
      n_tiles > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int threads = ck::mt_thread_rows(row_block) * ck::MT_TC;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CK_DISPATCH_D(d, DT, {
    constexpr int CH = ck::MtChunk<DT>::value;
    const size_t smem = ck::nn_cell_smem_bytes(CH, d);
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
