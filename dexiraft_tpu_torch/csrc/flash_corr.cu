// Flash correlation lookup for Hopper (sm_90a): B1 flash_fused_step and
// B2 flash_local_corr_level of the PyTorch port.
//
// Replaces the TPU kernel `_flash_kernel` of dexiraft_tpu/ops/pallas_corr.py
// (launched through `_flash_forward` -> pl.pallas_call), in both of its
// instantiations: FUSED=true is `flash_fused_step` (the window lookup of
// every pyramid level contracted with the motion encoder's 1x1 corr conv,
// plus bias), FUSED=false is `flash_local_corr_level` (the windows alone).
//
// What it computes, per query pixel p and pyramid level l: the (2r+1)^2
// bilinear window of <f1[p], f2_l[.]> / sqrt(C) around coords[p] * s_l,
// zero outside the frame, in the reference's channel order (x offset on
// the slow axis: index = ix * (2r+1) + iy).
//
// Design. The TPU kernel builds the window from block x block^T matmuls
// and hat matrices because TPU gathers were slow; an H100 gathers fine,
// so this kernel takes the lattice form instead:
//   * one CTA per (batch item, tile of P query pixels); the tile's f1 rows
//     are staged in shared memory, pre-scaled by 1/sqrt(C);
//   * per level, coords are clipped to [-r-1, size+r] (every window that
//     the clip moves is all-zero, and the integer floor cannot overflow);
//     one warp per pixel takes the (2r+2)^2 lattice dots against f2 rows
//     read in their storage dtype (16-byte loads, upcast to fp32, fp32
//     accumulation), with lattice points outside the frame set to 0;
//   * the 4 corners are blended into the window;
//   * FUSED: window @ W_l is accumulated in a (P, F) fp32 tile in shared
//     memory that starts at the bias; only (P, F) is written. !FUSED: the
//     window channels are written. Degenerate levels (0 rows or columns)
//     give zero windows.
// Int8 scales are not applied here: the caller folds them into W (fused)
// or multiplies the window (lookup), as the JAX code does.
//
// Bound. At the v1 eval shape (55x128 queries, C=256, 4 levels, r=4,
// F=256) one fused call needs ~2.6 GFLOP of fp32 arithmetic against
// ~24 MB of compulsory traffic, so it is bound by operations (fp32 CUDA
// cores; the products have an fp32 operand, so no 16-bit tensor-core
// rate applies). This first version spends most of its time on the
// lattice dots, re-reading overlapping f2 rows through L1/L2; the
// tensor-core (wgmma) redesign is later work.

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_corr.h"

namespace {

constexpr int kPixels = 16;    // query pixels per CTA
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // lattice dots in flight per warp

// 16-byte chunk of a storage-dtype row dotted with fp32 f1 values.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kVec = 4;
  __device__ static float dot(const float* row, const float* f) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row));
    const float4 g = *reinterpret_cast<const float4*>(f);
    return v.x * g.x + v.y * g.y + v.z * g.z + v.w * g.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float dot(const __nv_bfloat16* row, const float* f) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      s += v.x * f[2 * i] + v.y * f[2 * i + 1];
    }
    return s;
  }
};

template <>
struct Chunk<int8_t> {
  static constexpr int kVec = 16;
  __device__ static float dot(const int8_t* row, const float* f) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(row));
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) s += static_cast<float>(q[i]) * f[i];
    return s;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_corr_kernel(const FlashCorrArgs a) {
  const int r = a.radius;
  const int win = 2 * r + 1;
  const int kk = win * win;      // window channels per level
  const int k1 = 2 * r + 2;      // lattice side
  const int k2 = k1 * k1;
  const int C = a.c;
  const int N = a.n;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kPixels;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) float smem[];
  float* f1s = smem;                      // [kPixels][C]
  float* lattice = f1s + kPixels * C;     // [kPixels][k2]
  float* window = lattice + kPixels * k2; // [kPixels][kk]
  float* frac = window + kPixels * kk;    // [kPixels][2]
  float* acc = frac + 2 * kPixels;        // [kPixels][F]   (FUSED)

  const float inv_sqrt_c = rsqrtf(static_cast<float>(C));
  for (int i = tid; i < kPixels * C; i += kThreads) {
    const int p = i / C;
    const int n = n0 + p;
    f1s[i] = n < N ? a.f1[(static_cast<size_t>(b) * N + n) * C + i % C] *
                         inv_sqrt_c
                   : 0.f;
  }
  if (FUSED) {
    for (int i = tid; i < kPixels * a.feat; i += kThreads)
      acc[i] = a.bias[i % a.feat];
  }
  __syncthreads();

  for (int l = 0; l < a.num_levels; ++l) {
    const int h2 = a.h2[l];
    const int w2 = a.w2[l];
    if (FUSED && (h2 == 0 || w2 == 0)) continue;  // contributes nothing
    const T* f2 = static_cast<const T*>(a.level[l]);

    // ---- lattice dots: one warp per pixel --------------------------------
    for (int p = warp; p < kPixels; p += kWarps) {
      const int n = n0 + p;
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
      if (lane == 0) {
        frac[2 * p] = cx - x0;
        frac[2 * p + 1] = cy - y0;
      }
      const int gx0 = static_cast<int>(x0) - r;
      const int gy0 = static_cast<int>(y0) - r;
      const float* fp = f1s + p * C;
      for (int k0 = 0; k0 < k2; k0 += kUnroll) {
        const T* rows[kUnroll];
        float s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + u;
          const int gx = gx0 + k % k1;
          const int gy = gy0 + k / k1;
          const bool ok = k < k2 && gx >= 0 && gx < w2 && gy >= 0 && gy < h2;
          rows[u] = ok ? f2 + ((static_cast<size_t>(b) * h2 + gy) * w2 + gx) *
                                  static_cast<size_t>(C)
                       : nullptr;
          s[u] = 0.f;
        }
        for (int c = lane * Chunk<T>::kVec; c < C; c += 32 * Chunk<T>::kVec) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (rows[u] != nullptr) s[u] += Chunk<T>::dot(rows[u] + c, fp + c);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float v = warp_sum(s[u]);
          if (lane == 0 && k0 + u < k2) lattice[p * k2 + k0 + u] = v;
        }
      }
    }
    __syncthreads();

    // ---- corner blend, x offset slow; pixel index fastest ------------------
    for (int i = tid; i < kPixels * kk; i += kThreads) {
      const int p = i % kPixels;
      const int t = i / kPixels;
      const int ix = t / win;
      const int iy = t % win;
      const float fx = frac[2 * p];
      const float fy = frac[2 * p + 1];
      const float* L = lattice + p * k2 + iy * k1 + ix;
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
        float part[kPixels];
#pragma unroll
        for (int p = 0; p < kPixels; ++p) part[p] = 0.f;
        for (int t = 0; t < kk; ++t) {
          const float wt = __ldg(w + static_cast<size_t>(t) * a.feat + f);
#pragma unroll
          for (int p = 0; p < kPixels; ++p) part[p] += window[p * kk + t] * wt;
        }
#pragma unroll
        for (int p = 0; p < kPixels; ++p) acc[p * a.feat + f] += part[p];
      }
      __syncthreads();
    }
  }

  if (FUSED) {
    for (int i = tid; i < kPixels * a.feat; i += kThreads) {
      const int p = i % kPixels;
      const int f = i / kPixels;
      if (n0 + p < N)
        a.out[(static_cast<size_t>(b) * a.feat + f) * N + n0 + p] =
            acc[p * a.feat + f];
    }
  }
}

template <typename T, bool FUSED>
cudaError_t launch(const FlashCorrArgs& a, cudaStream_t stream) {
  const int r = a.radius;
  const int kk = (2 * r + 1) * (2 * r + 1);
  const int k2 = (2 * r + 2) * (2 * r + 2);
  const size_t floats = static_cast<size_t>(kPixels) *
                        (a.c + k2 + kk + 2 + (FUSED ? a.feat : 0));
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_corr_kernel<T, FUSED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.n + kPixels - 1) / kPixels, a.batch);
  flash_corr_kernel<T, FUSED><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool FUSED>
cudaError_t launch_dtype(const FlashCorrArgs& a, int dtype,
                         cudaStream_t stream) {
  switch (dtype) {
    case FLASH_FP32: return launch<float, FUSED>(a, stream);
    case FLASH_BF16: return launch<__nv_bfloat16, FUSED>(a, stream);
    case FLASH_INT8: return launch<int8_t, FUSED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t flash_corr_launch(const FlashCorrArgs& args, int dtype, bool fused,
                              cudaStream_t stream) {
  return fused ? launch_dtype<true>(args, dtype, stream)
               : launch_dtype<false>(args, dtype, stream);
}
