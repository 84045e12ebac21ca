// Bidirectional multi-radius population counts over an upper-triangular
// tile list.
//
// Replaces the TPU kernel clustering_tpu/ops/pallas_kernels.py:
// _pops_bidir_kernel (called through _pops_bidir_call /
// pops_tiles_bidir_all). Each strictly-upper pair row < col < n_valid of a
// listed tile with d2 <= r^2 adds 1 to both frames' counts at radius r;
// bit r of the tile's rmask gates radius r. The diagonal +1 is added by
// the Python wrapper.
//
// What bounds it on the H100: per pair, D fp32 subtract + fma, one compare
// per radius and the count bookkeeping; a few bytes of coordinates per
// pair come from L2 through shared memory. The TPU kept the column counts
// of the whole sweep resident in VMEM; here CTAs run in any order, so the
// cross-tile sums become global atomics, and the design keeps their number
// low: row counts live in registers for the whole tile (one atomicAdd per
// row and radius), column counts are warp ballots whose popcounts
// accumulate in the register of the lane owning that column, then in
// shared memory across warps, and reach global memory once per chunk and
// only where non-zero.

#include "common.cuh"

namespace {

constexpr int MAX_R = 8;  // radii per launch; the wrapper groups larger sets

template <int DT>
__global__ void pops_bidir_kernel(const float* __restrict__ ct, int64_t n_pad,
                                  int d, const float* __restrict__ radii2,
                                  int n_radii, int n_valid,
                                  const int* __restrict__ ti,
                                  const int* __restrict__ tj,
                                  const int* __restrict__ rmask,
                                  int row_block, int col_block,
                                  int* __restrict__ out) {
  constexpr int CH = ck::Chunk<DT>::value;
  extern __shared__ float smem[];
  float* ys = smem;                                   // d * CH
  int* s_col = reinterpret_cast<int*>(ys + d * CH);  // MAX_R * CH

  const int k = blockIdx.x;
  const int i = ti[k];
  const int j = tj[k];
  const int rm = rmask[k];
  if (j < 0 || rm == 0) return;  // no-op pad, or no radius admissible

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t row0 = (int64_t)i * row_block;
  const int64_t row = row0 + tid;
  const bool row_on = tid < row_block;
  const int64_t colbase = (int64_t)j * col_block;

  float r2[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) r2[r] = r < n_radii ? radii2[r] : -1.0f;

  ck::RowCoords<DT> x;
  x.load(ct, n_pad, row_on ? row : row0, d);

  int rowcnt[MAX_R];
  int colacc[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) rowcnt[r] = colacc[r] = 0;

  for (int e = tid; e < MAX_R * CH; e += blockDim.x) s_col[e] = 0;

  for (int off = 0; off < col_block; off += CH) {
    const int64_t col0 = colbase + off;
    const int ch = min(CH, col_block - off);
    if (col0 >= n_valid) break;
    // every column of this chunk at or left of the tile's first row:
    // no strictly-upper pair here
    if (col0 + ch - 1 <= row0) continue;
    __syncthreads();
    ck::stage_cols(ys, ct, n_pad, d, col0, ch);
    __syncthreads();
    for (int c = 0; c < ch; ++c) {
      const int64_t col = col0 + c;
      const float d2 = x.dist2(ys, ch, c, d);
      const bool base = row_on && col > row && col < n_valid;
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) {
        if ((rm >> r) & 1) {
          const bool w = base && d2 <= r2[r];
          rowcnt[r] += w;
          const unsigned b = __ballot_sync(FULL_MASK, w);
          if (lane == (c & 31)) colacc[r] += __popc(b);
        }
      }
      if ((c & 31) == 31 || c == ch - 1) {
        const int cl = (c & ~31) + lane;
#pragma unroll
        for (int r = 0; r < MAX_R; ++r) {
          if (colacc[r] != 0) {
            atomicAdd(&s_col[r * CH + cl], colacc[r]);
            colacc[r] = 0;
          }
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < n_radii * ch; e += blockDim.x) {
      const int r = e / ch;
      const int c = e - r * ch;
      const int v = s_col[r * CH + c];
      if (v != 0) {
        atomicAdd(&out[(int64_t)r * n_pad + col0 + c], v);
        s_col[r * CH + c] = 0;
      }
    }
  }
  if (row_on) {
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (rowcnt[r] != 0) atomicAdd(&out[(int64_t)r * n_pad + row], rowcnt[r]);
    }
  }
}

}  // namespace

extern "C" int ck_pops_bidir(const float* coords_t, long long n_pad, int d,
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
    constexpr int CH = ck::Chunk<DT>::value;
    const size_t smem = (size_t)CH * d * sizeof(float) +
                        (size_t)MAX_R * CH * sizeof(int);
    if (smem > (48u << 10))
      cudaFuncSetAttribute(pops_bidir_kernel<DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    pops_bidir_kernel<DT><<<(unsigned)n_tiles, threads, smem, st>>>(
        coords_t, (int64_t)n_pad, d, radii2, n_radii, n_valid, ti, tj, rmask,
        row_block, col_block, out);
  });
  return (int)cudaGetLastError();
}
