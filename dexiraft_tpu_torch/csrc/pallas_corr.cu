// Per-pixel correlation lookup for Hopper (sm_90a): B3 pallas_fused_step and
// B4 pallas_local_corr_level of the PyTorch port.
//
// Replaces the TPU kernels of dexiraft_tpu/ops/pallas_corr.py that the
// corr_impl="pallas" path launches:
//   * FUSED=true  is `pallas_fused_step` (pallas_corr.py:542 ->
//     `_fused_forward` -> pl.pallas_call with `_fused_kernel`): the window
//     lookup of every pyramid level contracted with the motion encoder's
//     1x1 corr conv, plus bias, one launch per refinement iteration;
//   * FUSED=false is `pallas_local_corr_level` (pallas_corr.py:276 ->
//     `_pallas_forward` -> pl.pallas_call with `_corr_kernel` or
//     `_corr_kernel_batched`, two TPU tunings of one function): one
//     level's windows.
//
// What it computes, per query pixel p and pyramid level l: coords[p] * s_l
// clipped to [-r-1, size+r] (every window the clip moves is all-zero, and
// the integer floor cannot overflow; a NaN center clips to the low edge),
// floor and fraction, the (2r+2)^2 integer-lattice dots <f1[p], f2_l[.]> /
// sqrt(C) with points outside the frame at 0, and the 4-corner blend into
// the (2r+1)^2 window in the reference's channel order (x offset on the
// slow axis: index = ix * (2r+1) + iy).
//
// Design: the shape of the reference's own CUDA kernel (alt_cuda_corr), not
// of B1 (csrc/flash_corr.cu, one warp per pixel reading f2 rows straight
// from global memory). Here
//   * a CTA owns a tile of P query pixels of one batch item and walks the C
//     channels in chunks of kChunk;
//   * for each chunk it stages in shared memory the tile's f1 chunk (scaled
//     by 1/sqrt(C)) and the same channel chunk of every pixel's (2r+2)^2
//     lattice rows, upcast to fp32 from the storage dtype (16-byte loads).
//     Rows outside the frame are staged as zeros, so no zero-padded copy of
//     a level is made (the TPU code pads every level in HBM first);
//   * each thread owns up to kMaxDots (pixel, lattice point) dots and
//     accumulates them in fp32 registers across the chunks;
//   * the corner blend reads the dots from shared memory; FUSED contracts
//     the window with W_l into a (P, F) fp32 accumulator in shared memory
//     that starts at the bias, and only (P, F) is written. !FUSED writes the
//     window channels. A 0-row level contributes nothing (FUSED) or zeros.
// Int8 scales are not applied here: the caller folds them into W (fused) or
// multiplies the window (lookup), as the JAX code does.
//
// Bound. At the v5 shape (dual stream, batch 2 x 55x128 queries, C=256, 4
// levels, r=4, F=256) one fused call needs ~4.5 GFLOP of fp32 arithmetic
// (lattice dots, blend, window @ W) against ~48 MB of compulsory traffic, so
// it is bound by operations on the fp32 CUDA cores (every product has an
// fp32 operand). This first version stages each pixel's lattice rows anew,
// although neighbouring pixels' lattices overlap, so it moves ~100x the
// compulsory bytes through L2 and shared memory; sharing a staged f2 patch
// across the tile, or the tensor-core formulation of B1's redesign, is later
// work.

#include <cuda_bf16.h>
#include <stdint.h>

#include "pallas_corr.h"

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kChunk = 16;             // channels staged per pass
constexpr int kStride = kChunk + 4;    // padded shared row: float4 reads of
                                       // 8 neighbouring rows hit 32 banks
constexpr int kMaxDots = 4;            // (pixel, lattice point) dots/thread
constexpr int kMaxPixels = 8;          // query pixels per CTA, at most

// One 16-byte vector of a storage-dtype row, upcast into fp32 shared memory.
template <typename T>
struct Stage;

template <>
struct Stage<float> {
  static constexpr int kVec = 4;
  __device__ static void load(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) =
        __ldg(reinterpret_cast<const float4*>(src));
  }
};

template <>
struct Stage<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 a = __bfloat1622float2(h[2 * i]);
      const float2 b = __bfloat1622float2(h[2 * i + 1]);
      d[i] = make_float4(a.x, a.y, b.x, b.y);
    }
  }
};

template <>
struct Stage<int8_t> {
  static constexpr int kVec = 16;
  __device__ static void load(const int8_t* src, float* dst) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(src));
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[i] = make_float4(q[4 * i], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]);
  }
};

template <typename T>
__device__ __forceinline__ void stage_zero(float* dst) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < Stage<T>::kVec / 4; ++i)
    d[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename T, bool FUSED>
__global__ void __launch_bounds__(kThreads)
pallas_corr_kernel(const PallasCorrArgs a) {
  const int r = a.radius;
  const int win = 2 * r + 1;
  const int kk = win * win;      // window channels per level
  const int k1 = 2 * r + 2;      // lattice side
  const int k2 = k1 * k1;
  const int P = a.pixels;
  const int nd = P * k2;         // dots per level of this tile
  const int C = a.c;
  const int N = a.n;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * P;
  const int tid = threadIdx.x;
  constexpr int kVec = Stage<T>::kVec;
  constexpr int kVecs = kChunk / kVec;  // vectors per staged row chunk

  extern __shared__ __align__(16) float smem[];
  float* lat = smem;                      // [P * k2][kStride] lattice rows
  float* f1s = lat + nd * kStride;        // [P][kStride]
  float* dots = f1s + P * kStride;        // [P * k2]
  float* frac = dots + nd;                // [P][2]
  float* window = frac + 2 * P;           // [P][kk]      (FUSED)
  float* acc = window + (FUSED ? P * kk : 0);  // [P][F]  (FUSED)
  int* origin = reinterpret_cast<int*>(acc + (FUSED ? P * a.feat : 0));
                                          // [P][2] lattice origin (x, y)

  const float inv_sqrt_c = rsqrtf(static_cast<float>(C));
  if (FUSED) {
    for (int i = tid; i < P * a.feat; i += kThreads)
      acc[i] = a.bias[i % a.feat];
  }

  for (int l = 0; l < a.num_levels; ++l) {
    const int h2 = a.h2[l];
    const int w2 = a.w2[l];
    if (FUSED && (h2 == 0 || w2 == 0)) continue;  // contributes nothing
    const T* f2 = static_cast<const T*>(a.level[l]);

    // ---- index prep: clip, floor, fraction, lattice origin ---------------
    if (tid < P) {
      const int n = n0 + tid;
      float cx = -1e30f, cy = -1e30f;  // padded tail pixel: all-zero window
      if (n < N) {
        const float* co = a.coords + (static_cast<size_t>(b) * N + n) * 2;
        cx = co[0] * a.coord_scale[l];
        cy = co[1] * a.coord_scale[l];
      }
      // fmaxf/fminf also send a NaN center to the (all-zero) low clip
      cx = fminf(fmaxf(cx, -(r + 1.f)), w2 + static_cast<float>(r));
      cy = fminf(fmaxf(cy, -(r + 1.f)), h2 + static_cast<float>(r));
      const float x0 = floorf(cx);
      const float y0 = floorf(cy);
      frac[2 * tid] = cx - x0;
      frac[2 * tid + 1] = cy - y0;
      origin[2 * tid] = static_cast<int>(x0) - r;
      origin[2 * tid + 1] = static_cast<int>(y0) - r;
    }
    __syncthreads();

    // ---- lattice dots, channel chunk by channel chunk ---------------------
    float part[kMaxDots];
#pragma unroll
    for (int j = 0; j < kMaxDots; ++j) part[j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      for (int i = tid; i < P * kChunk; i += kThreads) {
        const int p = i / kChunk;
        const int cc = i % kChunk;
        const int n = n0 + p;
        f1s[p * kStride + cc] =
            n < N ? a.f1[(static_cast<size_t>(b) * N + n) * C + c0 + cc] *
                        inv_sqrt_c
                  : 0.f;
      }
      for (int i = tid; i < nd * kVecs; i += kThreads) {
        const int row = i / kVecs;
        const int v = i % kVecs;
        const int p = row / k2;
        const int k = row % k2;
        const int gx = origin[2 * p] + k % k1;
        const int gy = origin[2 * p + 1] + k / k1;
        float* dst = lat + row * kStride + v * kVec;
        if (gx >= 0 && gx < w2 && gy >= 0 && gy < h2) {
          Stage<T>::load(f2 + ((static_cast<size_t>(b) * h2 + gy) * w2 + gx) *
                                  static_cast<size_t>(C) +
                              c0 + v * kVec,
                         dst);
        } else {
          stage_zero<T>(dst);
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMaxDots; ++j) {
        const int d = tid + j * kThreads;
        if (d < nd) {
          const float4* x = reinterpret_cast<const float4*>(lat + d * kStride);
          const float4* f =
              reinterpret_cast<const float4*>(f1s + (d / k2) * kStride);
          float s = part[j];
#pragma unroll
          for (int q = 0; q < kChunk / 4; ++q) {
            const float4 xv = x[q];
            const float4 fv = f[q];
            s += xv.x * fv.x + xv.y * fv.y + xv.z * fv.z + xv.w * fv.w;
          }
          part[j] = s;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kMaxDots; ++j) {
      const int d = tid + j * kThreads;
      if (d < nd) dots[d] = part[j];
    }
    __syncthreads();

    // ---- corner blend, x offset slow; pixel index fastest ------------------
    for (int i = tid; i < P * kk; i += kThreads) {
      const int p = i % P;
      const int t = i / P;
      const int ix = t / win;
      const int iy = t % win;
      const float fx = frac[2 * p];
      const float fy = frac[2 * p + 1];
      const float* L = dots + p * k2 + iy * k1 + ix;
      const float v = (1.f - fy) * ((1.f - fx) * L[0] + fx * L[1]) +
                      fy * ((1.f - fx) * L[k1] + fx * L[k1 + 1]);
      if (FUSED) {
        window[p * kk + t] = v;
      } else if (n0 + p < N) {
        a.out[(static_cast<size_t>(b) * a.num_levels * kk + l * kk + t) * N +
              n0 + p] = v;
      }
    }
    __syncthreads();

    // ---- fused 1x1 conv: acc[p, f] += sum_t window[p, t] * W[l*kk + t, f] --
    if (FUSED) {
      const float* w = a.weight + static_cast<size_t>(l) * kk * a.feat;
      for (int f = tid; f < a.feat; f += kThreads) {
        float s[kMaxPixels];
#pragma unroll
        for (int p = 0; p < kMaxPixels; ++p) s[p] = 0.f;
        for (int t = 0; t < kk; ++t) {
          const float wt = __ldg(w + static_cast<size_t>(t) * a.feat + f);
#pragma unroll
          for (int p = 0; p < kMaxPixels; ++p)
            if (p < P) s[p] += window[p * kk + t] * wt;
        }
#pragma unroll
        for (int p = 0; p < kMaxPixels; ++p)
          if (p < P) acc[p * a.feat + f] += s[p];
      }
      __syncthreads();
    }
  }

  if (FUSED) {
    for (int i = tid; i < P * a.feat; i += kThreads) {
      const int p = i % P;
      const int f = i / P;
      if (n0 + p < N)
        a.out[(static_cast<size_t>(b) * a.feat + f) * N + n0 + p] =
            acc[p * a.feat + f];
    }
  }
}

template <typename T, bool FUSED>
cudaError_t launch(PallasCorrArgs a, cudaStream_t stream) {
  const int r = a.radius;
  const int kk = (2 * r + 1) * (2 * r + 1);
  const int k2 = (2 * r + 2) * (2 * r + 2);
  // as many pixels as the threads' dot registers hold (8 at r <= 4)
  const int fit = kThreads * kMaxDots / k2;
  const int P = fit < kMaxPixels ? fit : kMaxPixels;
  if (P < 1) return cudaErrorInvalidValue;
  a.pixels = P;
  const size_t floats =
      static_cast<size_t>(P) * k2 * kStride + P * kStride + P * k2 + 2 * P +
      (FUSED ? static_cast<size_t>(P) * (kk + a.feat) : 0) + 2 * P;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pallas_corr_kernel<T, FUSED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.n + P - 1) / P, a.batch);
  pallas_corr_kernel<T, FUSED><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool FUSED>
cudaError_t launch_dtype(const PallasCorrArgs& a, int dtype,
                         cudaStream_t stream) {
  switch (dtype) {
    case PALLAS_FP32: return launch<float, FUSED>(a, stream);
    case PALLAS_BF16: return launch<__nv_bfloat16, FUSED>(a, stream);
    case PALLAS_INT8: return launch<int8_t, FUSED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t pallas_corr_launch(PallasCorrArgs args, int dtype, bool fused,
                               cudaStream_t stream) {
  return fused ? launch_dtype<true>(args, dtype, stream)
               : launch_dtype<false>(args, dtype, stream);
}
