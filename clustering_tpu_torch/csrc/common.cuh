// Shared pieces of the pairwise tile-sweep kernels.
//
// Layout (the same as the JAX package's Pallas kernels): coordinates are
// (D, N_pad) float32, frame axis contiguous, pads at 3e38. A sweep visits
// a flat list of (ti, tj) tiles of row_block x col_block frames; one CTA
// takes one tile entry. In the one-row-per-thread kernels (the first part
// of this file) thread t holds row ti*row_block + t, with its D
// coordinates in registers when D is a compile-time constant, and columns
// are staged through shared memory in chunks of CHUNK frames. The
// register micro-tiles of the second part serve nn_bidir and
// label_min_bidir.
//
// Distance arithmetic is the plain fma chain from zero, in ascending
// dimension order: diff = x - y; acc = fma(diff, diff, acc). It is
// bit-equal to the Pallas kernels run in interpret mode and to the port's
// plain PyTorch versions (torch.addcmul).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

namespace ck {

// columns staged per shared-memory chunk: with a compile-time D the chunk
// holds D * 256 floats (16 KB at D = 16); with a runtime D (D > 16) 32
// columns per chunk keep the staging area small for any D
constexpr int CHUNK_T = 256;
constexpr int CHUNK_R = 32;
constexpr int MAX_DT = 16;

template <int DT>
struct Chunk {
  static constexpr int value = DT > 0 ? CHUNK_T : CHUNK_R;
};

// Row coordinates: registers for a compile-time D, global reads (through
// L1) for the runtime-D fallback.
template <int DT>
struct RowCoords {
  float v[DT];
  __device__ __forceinline__ void load(const float* __restrict__ ct,
                                       int64_t n_pad, int64_t row, int) {
#pragma unroll
    for (int k = 0; k < DT; ++k) v[k] = ct[(int64_t)k * n_pad + row];
  }
  // squared distance to staged column c of a chunk of width ch
  __device__ __forceinline__ float dist2(const float* ys, int ch, int c,
                                         int) const {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < DT; ++k) {
      float diff = v[k] - ys[k * ch + c];
      acc = __fmaf_rn(diff, diff, acc);
    }
    return acc;
  }
};

template <>
struct RowCoords<0> {
  const float* base;
  int64_t n_pad;
  __device__ __forceinline__ void load(const float* __restrict__ ct,
                                       int64_t n_pad_, int64_t row, int) {
    base = ct + row;
    n_pad = n_pad_;
  }
  __device__ __forceinline__ float dist2(const float* ys, int ch, int c,
                                         int d) const {
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) {
      float diff = base[(int64_t)k * n_pad] - ys[k * ch + c];
      acc = __fmaf_rn(diff, diff, acc);
    }
    return acc;
  }
};

// Stage columns [col0, col0 + ch) of the (D, N_pad) matrix into ys
// (k-major, stride ch). All threads of the CTA take part.
__device__ __forceinline__ void stage_cols(float* ys,
                                           const float* __restrict__ ct,
                                           int64_t n_pad, int d,
                                           int64_t col0, int ch) {
  for (int e = threadIdx.x; e < d * ch; e += blockDim.x) {
    int k = e / ch;
    int c = e - k * ch;
    ys[e] = ct[(int64_t)k * n_pad + col0 + c];
  }
}

// Threads per CTA: one per tile row, rounded up to whole warps.
inline int cta_threads(int row_block) { return ((row_block + 31) / 32) * 32; }

inline size_t col_smem_bytes(int dt, int d) {
  return (size_t)(dt > 0 ? CHUNK_T : CHUNK_R) * (size_t)d * sizeof(float);
}

}  // namespace ck

// -- register micro-tiles (nn_bidir, label_min_bidir) ------------------------
//
// A CTA of TR x MT_TC threads sweeps a tile in row passes of TR * MT_RM
// rows. Thread (tr, tc) owns the MT_RM rows p0 + tr + TR * m in registers
// for the whole pass and, in each step, the MT_RN contiguous staged
// columns cbase + MT_RN * tc + n: MT_RM * MT_RN independent fma chains per
// step.
// Columns are staged MT_CH<DT> at a time through two shared buffers that
// cp.async fills one chunk ahead. Rows and columns outside the sweep are
// staged as NaN, so their d2 is NaN and fails every compare: the inner
// loop has no bounds tests.
namespace ck {

constexpr int MT_RM = 4;
constexpr int MT_RN = 4;
constexpr int MT_TC = 8;
constexpr int MT_STEP = MT_TC * MT_RN;  // columns per step
constexpr int MT_MAX_TR = 32;           // 256 threads, 128 rows a pass

template <int DT>
struct MtChunk {
  static constexpr int value = DT > 0 ? 512 : MT_STEP;
};

// thread rows for a row block: enough for one pass, at most MT_MAX_TR
inline int mt_thread_rows(int row_block) {
  const int tr = (row_block + MT_RM - 1) / MT_RM;
  return tr < MT_MAX_TR ? tr : MT_MAX_TR;
}

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of columns [col0, col0 + CH) of the (D, N_pad) matrix
// into ys (k-major, stride CH); columns at or past ch or n_limit get NaN.
template <int CH>
__device__ __forceinline__ void mt_stage_cols(float* ys,
                                              const float* __restrict__ ct,
                                              int64_t n_pad, int d,
                                              int64_t col0, int ch,
                                              int64_t n_limit) {
  for (int e = threadIdx.x; e < d * CH; e += blockDim.x) {
    const int k = e / CH;
    const int c = e - k * CH;
    if (c < ch && col0 + c < n_limit)
      cp_async4(&ys[e], &ct[(int64_t)k * n_pad + col0 + c]);
    else
      ys[e] = qnan();
  }
}

// A pass's row coordinates: registers for a compile-time D; for the
// runtime-D instance, pointers read through L1 in the inner loop.
template <int DT>
struct MtRows {
  float v[MT_RM][DT];
  __device__ __forceinline__ void load(const float* __restrict__ ct,
                                       int64_t n_pad, int,
                                       const int64_t (&row)[MT_RM],
                                       const bool (&ok)[MT_RM]) {
#pragma unroll
    for (int m = 0; m < MT_RM; ++m)
#pragma unroll
      for (int k = 0; k < DT; ++k)
        v[m][k] = ok[m] ? ct[(int64_t)k * n_pad + row[m]] : qnan();
  }
  __device__ __forceinline__ float get(int m, int k) const {
    return v[m][k];
  }
};

template <>
struct MtRows<0> {
  const float* p[MT_RM];
  int64_t n_pad;
  __device__ __forceinline__ void load(const float* __restrict__ ct,
                                       int64_t n_pad_, int,
                                       const int64_t (&row)[MT_RM],
                                       const bool (&ok)[MT_RM]) {
    n_pad = n_pad_;
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) p[m] = ok[m] ? ct + row[m] : nullptr;
  }
  __device__ __forceinline__ float get(int m, int k) const {
    return p[m] ? p[m][(int64_t)k * n_pad] : qnan();
  }
};

// d2[m][n] between the pass rows and the step's MT_RN contiguous columns
// c0 .. c0 + MT_RN - 1 of a staged chunk (c0 a multiple of MT_RN: one
// 16-byte shared load per dimension), each the fma chain from zero in
// ascending dimension order.
template <int DT, int CH>
__device__ __forceinline__ void mt_dist2(const MtRows<DT>& x,
                                         const float* ys, int d, int c0,
                                         float (&d2)[MT_RM][MT_RN]) {
  static_assert(MT_RN == 4, "one float4 of columns per dimension");
#pragma unroll
  for (int m = 0; m < MT_RM; ++m)
#pragma unroll
    for (int n = 0; n < MT_RN; ++n) d2[m][n] = 0.0f;
  const int dd = DT > 0 ? DT : d;
#pragma unroll
  for (int k = 0; k < dd; ++k) {
    const float4 y4 = *reinterpret_cast<const float4*>(&ys[k * CH + c0]);
    const float y[MT_RN] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int m = 0; m < MT_RM; ++m) {
      const float xm = x.get(m, k);
#pragma unroll
      for (int n = 0; n < MT_RN; ++n) {
        const float diff = xm - y[n];
        d2[m][n] = __fmaf_rn(diff, diff, d2[m][n]);
      }
    }
  }
}

// shuffle mask of the CTA's (possibly partial) warp
__device__ __forceinline__ unsigned mt_warp_mask() {
  const int base = threadIdx.x & ~31;
  const int live = (int)blockDim.x - base;
  return live >= 32 ? FULL_MASK : ((1u << live) - 1u);
}

}  // namespace ck

// Dispatch a kernel template on D: a compile-time instance for
// 1 <= D <= 16, the runtime-D instance (DT = 0) above that.
#define CK_DISPATCH_D(d, DT, ...)         \
  switch (d) {                            \
    case 1: { constexpr int DT = 1; __VA_ARGS__; } break;   \
    case 2: { constexpr int DT = 2; __VA_ARGS__; } break;   \
    case 3: { constexpr int DT = 3; __VA_ARGS__; } break;   \
    case 4: { constexpr int DT = 4; __VA_ARGS__; } break;   \
    case 5: { constexpr int DT = 5; __VA_ARGS__; } break;   \
    case 6: { constexpr int DT = 6; __VA_ARGS__; } break;   \
    case 7: { constexpr int DT = 7; __VA_ARGS__; } break;   \
    case 8: { constexpr int DT = 8; __VA_ARGS__; } break;   \
    case 9: { constexpr int DT = 9; __VA_ARGS__; } break;   \
    case 10: { constexpr int DT = 10; __VA_ARGS__; } break; \
    case 11: { constexpr int DT = 11; __VA_ARGS__; } break; \
    case 12: { constexpr int DT = 12; __VA_ARGS__; } break; \
    case 13: { constexpr int DT = 13; __VA_ARGS__; } break; \
    case 14: { constexpr int DT = 14; __VA_ARGS__; } break; \
    case 15: { constexpr int DT = 15; __VA_ARGS__; } break; \
    case 16: { constexpr int DT = 16; __VA_ARGS__; } break; \
    default: { constexpr int DT = 0; __VA_ARGS__; } break;  \
  }
