// Shared pieces of the three pairwise tile-sweep kernels.
//
// Layout (the same as the JAX package's Pallas kernels): coordinates are
// (D, N_pad) float32, frame axis contiguous, pads at 3e38. A sweep visits
// a flat list of (ti, tj) tiles of row_block x col_block frames; one CTA
// takes one tile entry. Thread t holds row ti*row_block + t, with its D
// coordinates in registers when D is a compile-time constant. Columns are
// staged through shared memory in chunks of CHUNK frames.
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

__device__ __forceinline__ unsigned long long warp_min_u64(
    unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(FULL_MASK, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// Threads per CTA: one per tile row, rounded up to whole warps.
inline int cta_threads(int row_block) { return ((row_block + 31) / 32) * 32; }

inline size_t col_smem_bytes(int dt, int d) {
  return (size_t)(dt > 0 ? CHUNK_T : CHUNK_R) * (size_t)d * sizeof(float);
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
