// Flash correlation lookup for Hopper (sm_90a): B1 flash_fused_step and
// B2 flash_local_corr_level of the PyTorch port.
//
// Replaces the TPU kernel `_flash_kernel` of dexiraft_tpu/ops/pallas_corr.py
// (pallas_corr.py:648, launched through `_flash_forward` :747 ->
// pl.pallas_call :832) in both of its instantiations:
//   * fused=true is `flash_fused_step` (pallas_corr.py:867): the window
//     lookup of every pyramid level contracted with the motion encoder's 1x1
//     corr conv, plus bias; here `flash_fused_tile_kernel`;
//   * fused=false is `flash_local_corr_level` (:847): the windows alone;
//     here `flash_lookup_kernel`.
//
// What both compute, per query pixel p and pyramid level l: coords[p] * s_l
// clipped to [-r-1, size+r] (every window the clip moves is all-zero, the
// integer floor cannot overflow, and a NaN center clips to the low edge),
// floor and fraction, the (2r+2)^2 integer-lattice dots <f1[p], f2_l[.]> /
// sqrt(C) with points outside the frame at 0, and the 4-corner blend into the
// (2r+1)^2 window in the reference's channel order (x offset on the slow
// axis: index = ix * (2r+1) + iy). Degenerate levels (0 rows or columns)
// give zero windows. Int8 scales are not applied here: the caller folds them
// into W (fused) or multiplies the window (lookup), as the JAX code does.
//
// ---- B1, flash_fused_tile_kernel ------------------------------------------
// Bound. At v5's kernel batch (2 x 55x128 queries, C=256, 4 levels, r=4,
// F=256) one call takes ~4.5 GFLOP of fp32 arithmetic (in-frame lattice
// dots, blend, window @ W) against ~48 MB of compulsory traffic: bound by
// operations on the fp32 CUDA cores (every product has an fp32 operand), 67
// us at the published peak. Neighbouring query pixels share most of their
// lattice rows: read per pixel, the rows are ~5.6 GB of L2->SM traffic per
// call, which is what held the one-warp-per-pixel kernel of the first port
// at ~0.9 ms. The TPU kernel shares them by DMA-ing each fmap2 row block
// once per 256-query block; this kernel shares them through shared memory:
//   * a CTA of 320 threads owns a 4x8 tile of query pixels of one batch
//     item. 4x8 rather than 4x16: 224 CTAs at v1's batch 1 and 448 at v5's
//     batch 2 keep all 132 SMs busy, where 64-pixel tiles would leave 20
//     SMs idle at v1; the box of a 4x8 tile at smooth flow is 13x17 = 221
//     positions against 3,200 lattice-row reads (14x reuse);
//   * per level, warp 0 takes each pixel's clipped lattice origin and the
//     bounding box of the tile's lattices, intersected with the frame. A
//     pixel whose whole effective lattice (the rows and columns its blend
//     weighs nonzero) lies outside the frame is left out of the box: its
//     window is zero (far or NaN coords, a tail pixel). A tile with no such
//     pixel left skips the level;
//   * patch branch, box (rows padded to an odd stride) <= Qmax positions:
//     the box of f2 is staged ONCE in shared memory, kUnits x 16 bytes of
//     channels per position at a time (fp32, bf16 or int8: 8, 16 or 32
//     channels), by cp.async 16-byte copies in the storage dtype, in a ring
//     of kStages so chunk k+1 is in flight while chunk k is dotted; f1's
//     chunk rides in the same stage. Each value is upcast to fp32 as it is
//     read from shared memory;
//   * per-pixel branch, box > Qmax (a flow discontinuity, scattered coords):
//     one warp per pixel, lanes across channels, reads each of the pixel's
//     in-frame lattice rows from global memory (16-byte __ldg), as the
//     first port did. The branch is chosen per (tile, level) from the data;
//     both compute the same sums;
//   * patch dots: a thread owns lattice row ky of a horizontal pixel pair
//     and half of each chunk's units, and keeps the pair's 2 x (2r+2) <= 20
//     kx sums in fp32 registers across the chunks (the halves are added in
//     shared memory). When every pair of a warp has its second pixel's row
//     one position right of the first's (smooth flow), 11 float4 reads feed
//     both rows' 20 dots, else 10 each. A pair's 8 first rows go to the 8
//     lanes of a quarter-warp: at the odd row stride they fall in 8
//     different bank groups whatever the coords. A radius above 4 takes
//     several passes of the whole chunk loop;
//   * the corner blend writes the (kk, 32) window into the idle stage
//     region; W_l's rows follow it there through cp.async, double-buffered,
//     the first two chunks during the blend; each thread takes 8 pixels
//     (one tile row) x 4 features FS/4 apart in registers; the [F][36]
//     accumulator starts at the bias and lives in shared memory across
//     levels; only (B, F, H, W) is written, a warp per feature and tile.
// Qmax is what fits when two CTAs share an SM (113 KB each): ~960
// positions at fp32, C=F=256, r=4, which takes the smoke's U(-6, 6) field
// (boxes of up to 24x28) on the patch branch at every level. On the card
// the call stays well above its bound without filling the shared-memory
// reads, the FMAs or L2: most of a CTA's time goes to issuing its many
// scattered 32-byte copies, and its chunks, barriers and phases run in
// sequence with only two CTAs per SM (PERF.md).
//
// The query grid (H, W) is level 0's shape (the pyramid's first level is
// fmap2 itself); were it not, the pixels are tiled as one row of N.
//
// ---- B2, flash_lookup_kernel ----------------------------------------------
// One CTA per 16 query pixels, one warp per pixel taking the (2r+2)^2
// lattice dots against f2 rows read from global memory (16-byte loads in
// the storage dtype, fp32 accumulation, warp-shuffle sums); the tile's f1
// rows staged in shared memory pre-scaled by 1/sqrt(C); the window channels
// are written. Bound by bytes at level 0 (~5 us); it re-reads overlapping
// f2 rows through L1/L2 and is B1's pre-patch design, to be redesigned the
// same way.

#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "flash_corr.h"

namespace {

// ============================ B2: the lookup ================================

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

// 4 CTAs per SM (<= 64 registers): the occupancy of the first port's
// build of this loop, whose L2 re-reads it needs to hide
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
flash_lookup_kernel(const FlashCorrArgs a) {
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
  float* frac = lattice + kPixels * k2;   // [kPixels][2]

  const float inv_sqrt_c = rsqrtf(static_cast<float>(C));
  for (int i = tid; i < kPixels * C; i += kThreads) {
    const int p = i / C;
    const int n = n0 + p;
    f1s[i] = n < N ? a.f1[(static_cast<size_t>(b) * N + n) * C + i % C] *
                         inv_sqrt_c
                   : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < a.num_levels; ++l) {
    const int h2 = a.h2[l];
    const int w2 = a.w2[l];
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
      if (n0 + p < N) {
        a.out[(static_cast<size_t>(b) * a.num_levels * kk + l * kk + t) * N +
              n0 + p] = v;
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_lookup(const FlashCorrArgs& a, cudaStream_t stream) {
  const int r = a.radius;
  const int k2 = (2 * r + 2) * (2 * r + 2);
  const size_t bytes =
      static_cast<size_t>(kPixels) * (a.c + k2 + 2) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_lookup_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.n + kPixels - 1) / kPixels, a.batch);
  flash_lookup_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ====================== B1: the fused patch-tile step =======================

constexpr int kTileH = 4;
constexpr int kTileW = 8;
constexpr int kTile = kTileH * kTileW;  // 32 query pixels: one per lane
constexpr int kTileThreads = 320;  // r=4: 16 pixel pairs x 10 rows x 2 halves
constexpr int kMaxKx = 10;         // dot accumulators per pixel and thread
constexpr int kUnits = 2;          // 16-byte units per position per stage
constexpr int kStages = 2;         // cp.async ring: kStages - 1 in flight
constexpr int kBudgetTwo = 113 * 1024;  // dynamic smem per CTA, 2 CTAs per SM
constexpr int kBudgetOne = 227 * 1024;  // the most one CTA may take
constexpr int kAccStride = kTile + 4;   // accumulator row of one feature

enum TileMode { kDead = 0, kPatch = 1, kPerPixel = 2 };

struct TileGeom {
  int hq, wq;         // query grid
  int qmax;           // patch positions a stage holds
  int stages_bytes;   // the stage region
  int fs;             // F rounded up to 4: a W row in shared memory
  int wrows;          // W rows per epilogue stage
  bool w_vec;         // W rows may be copied as float4s
  bool f1_vec;        // f1 rows may be copied as float4s
};

// 16 bytes of storage = kVec channels, upcast and dotted into one sum.
template <typename T>
struct Unit;

template <>
struct Unit<float> {
  static constexpr int kVec = 4;
  __device__ static float fma(const uint4 v, const float* f, float s) {
    s = fmaf(__uint_as_float(v.x), f[0], s);
    s = fmaf(__uint_as_float(v.y), f[1], s);
    s = fmaf(__uint_as_float(v.z), f[2], s);
    return fmaf(__uint_as_float(v.w), f[3], s);
  }
};

template <>
struct Unit<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float fma(const uint4 v, const float* f, float s) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> fp32: the high half of a float
      s = fmaf(__uint_as_float(w[i] << 16), f[2 * i], s);
      s = fmaf(__uint_as_float(w[i] & 0xffff0000u), f[2 * i + 1], s);
    }
    return s;
  }
};

template <>
struct Unit<int8_t> {
  static constexpr int kVec = 16;
  __device__ static float fma(const uint4 v, const float* f, float s) {
    // int8 -> fp32 without I2F: byte q ^ 0x80 placed in the mantissa of
    // 2^23 gives 2^23 + q + 128 exactly
    const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                           v.z ^ 0x80808080u, v.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float q =
            __uint_as_float(__byte_perm(w[i], 0x4b000000u, 0x7540 + j)) -
            8388736.f;
        s = fmaf(q, f[4 * i + j], s);
      }
    }
    return s;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One unit of channels of the lattice rows of a pixel pair whose rows are
// one position apart: kMaxKx + 1 positions feed both rows' kMaxKx dots.
template <typename T>
__device__ __forceinline__ void dot_pair(const uint4* src, const float* fa,
                                         const float* fb, float* da,
                                         float* db) {
#pragma unroll
  for (int m = 0; m <= kMaxKx; ++m) {
    const uint4 v = src[m];
    if (m < kMaxKx) da[m] = Unit<T>::fma(v, fa, da[m]);
    if (m > 0) db[m - 1] = Unit<T>::fma(v, fb, db[m - 1]);
  }
}

// One unit of channels of one lattice row: the kx dots of [klo, khi) (all
// kMaxKx when kFull) from consecutive patch positions.
template <typename T, bool kFull>
__device__ __forceinline__ void dot_row(const uint4* src, const float* f,
                                        int klo, int khi, float* dots) {
#pragma unroll
  for (int kx = 0; kx < kMaxKx; ++kx)
    if (kFull || (kx >= klo && kx < khi))
      dots[kx] = Unit<T>::fma(src[kx], f, dots[kx]);
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 2)
flash_fused_tile_kernel(const FlashCorrArgs a, const TileGeom g) {
  constexpr int kVec = Unit<T>::kVec;
  constexpr int kGroups = kUnits * kVec / 4;  // f1 float4s per pixel/stage
  constexpr int kTileWarps = kTileThreads / 32;
  const int r = a.radius;
  const int win = 2 * r + 1;
  const int kk = win * win;
  const int k1 = 2 * r + 2;
  const int k2 = k1 * k1;
  const int C = a.c;
  const int N = a.n;
  const int F = a.feat;
  const int FS = g.fs;
  const int qmax = g.qmax;
  const int units = C * static_cast<int>(sizeof(T)) / 16;  // per f2 row
  const int chunks = (units + kUnits - 1) / kUnits;
  const int kxb = (k1 + kMaxKx - 1) / kMaxKx;  // kx blocks per lattice row
  constexpr int kPairs = kTile / 2;  // horizontal pixel pairs of the tile
  const int per_half = kPairs * k1 * kxb;  // (pair, ky, kx block) items
  const int items = 2 * per_half;          // ... for each half of a chunk
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float inv_sqrt_c = rsqrtf(static_cast<float>(C));

  // shared memory: the stage region (two stages [patch units | f1 chunk];
  // the per-pixel branch's f1 rows and, between levels, the window alias
  // it), lattice dots [32][k2 + 1], accumulator [FS][36], per-pixel origin /
  // fraction / liveness, the tile's box
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int patch_bytes = kUnits * qmax * 16;
  const int stage_bytes = patch_bytes + kGroups * kTile * 16;
  unsigned char* stages = smem_raw;
  float* window = reinterpret_cast<float*>(stages);          // [kk][32]
  float* wbuf = window + kk * kTile;  // W rows: 2 x [g.wrows][FS]
  float* lattice = reinterpret_cast<float*>(stages + g.stages_bytes);
  const int ls = k2 + 1;  // lattice row stride: conflict-free both ways
  float* acc = lattice + kTile * ls;              // [FS][kAccStride]
  float* s_fx = acc + FS * kAccStride;
  float* s_fy = s_fx + kTile;
  int* s_gx0 = reinterpret_cast<int*>(s_fy + kTile);
  int* s_gy0 = s_gx0 + kTile;
  int* s_live = s_gy0 + kTile;
  int* s_box = s_live + kTile;  // mode, bx0, by0, width, height

  for (int i = tid; i < FS * kTile; i += kTileThreads) {
    const int f = i / kTile;
    acc[f * kAccStride + i % kTile] = f < F ? a.bias[f] : 0.f;
  }

  for (int l = 0; l < a.num_levels; ++l) {
    const int h2 = a.h2[l];
    const int w2 = a.w2[l];
    if (h2 == 0 || w2 == 0) continue;  // contributes nothing
    const T* f2 = static_cast<const T*>(a.level[l]);
    __syncthreads();  // the last level's epilogue is done with the window

    // ---- warp 0: clip, floor, fraction, liveness; the tile's box ---------
    if (warp == 0) {
      const int p = lane;
      const int y = ty0 + p / kTileW;
      const int x = tx0 + p % kTileW;
      const bool valid = y < g.hq && x < g.wq && y * g.wq + x < N;
      float cx = -1e30f, cy = -1e30f;  // padded tail pixel: all-zero window
      if (valid) {
        const float* co =
            a.coords + (static_cast<size_t>(b) * N + y * g.wq + x) * 2;
        cx = co[0] * a.coord_scale[l];
        cy = co[1] * a.coord_scale[l];
      }
      // fmaxf/fminf also send a NaN center to the (all-zero) low clip
      cx = fminf(fmaxf(cx, -(r + 1.f)), w2 + static_cast<float>(r));
      cy = fminf(fmaxf(cy, -(r + 1.f)), h2 + static_cast<float>(r));
      const float x0 = floorf(cx);
      const float y0 = floorf(cy);
      const float fx = cx - x0;
      const float fy = cy - y0;
      const int gx0 = static_cast<int>(x0) - r;
      const int gy0 = static_cast<int>(y0) - r;
      // the lattice columns/rows the blend weighs: the last one only at a
      // nonzero fraction
      const int ex = k1 - (fx == 0.f ? 1 : 0);
      const int ey = k1 - (fy == 0.f ? 1 : 0);
      const bool live =
          valid && gx0 + ex > 0 && gx0 < w2 && gy0 + ey > 0 && gy0 < h2;
      s_fx[p] = fx;
      s_fy[p] = fy;
      s_gx0[p] = gx0;
      s_gy0[p] = gy0;
      s_live[p] = live;
      const unsigned all = 0xffffffffu;
      const int bx0 = __reduce_min_sync(all, live ? max(gx0, 0) : INT32_MAX);
      const int bx1 = __reduce_max_sync(all, live ? min(gx0 + ex, w2) : 0);
      const int by0 = __reduce_min_sync(all, live ? max(gy0, 0) : INT32_MAX);
      const int by1 = __reduce_max_sync(all, live ? min(gy0 + ey, h2) : 0);
      const bool any = __any_sync(all, live);
      if (p == 0) {
        // the staged box's rows are padded to an odd stride, so any 8
        // rows of one column fall in 8 different bank groups
        const long long box =
            static_cast<long long>((bx1 - bx0) | 1) * (by1 - by0);
        s_box[0] = !any ? kDead : (box <= qmax ? kPatch : kPerPixel);
        s_box[1] = bx0;
        s_box[2] = by0;
        s_box[3] = bx1 - bx0;
        s_box[4] = by1 - by0;
      }
    }
    __syncthreads();
    const int mode = s_box[0];
    if (mode == kDead) continue;  // every window of the tile is zero

    if (mode == kPatch) {
      const int bx0 = s_box[1];
      const int by0 = s_box[2];
      const int bw = s_box[3];
      const int bs = bw | 1;  // row stride in the stage
      const int npos = bw * s_box[4];
      const float inv_bw = 1.f / bw;  // exact row of q < 2^21 from (q+.5)/bw

      // stage chunk k (units [k * kUnits, ...)) into buffer s
      auto stage = [&](int k, int s) {
        unsigned char* base = stages + s * stage_bytes;
        const int u0 = k * kUnits;
        for (int i = tid; i < kUnits * npos; i += kTileThreads) {
          const int u = i % kUnits;
          const int q = i / kUnits;
          if (u0 + u >= units) continue;
          const int qy = static_cast<int>((q + 0.5f) * inv_bw);
          const int qx = q - qy * bw;
          const T* src =
              f2 + ((static_cast<size_t>(b) * h2 + by0 + qy) * w2 + bx0 + qx) *
                       static_cast<size_t>(C) +
              static_cast<size_t>(u0 + u) * kVec;
          cp_async16(base + (static_cast<size_t>(u) * qmax + qy * bs + qx) * 16,
                     src);
        }
        float* f1s = reinterpret_cast<float*>(base + patch_bytes);
        const int cc = min(kUnits, units - u0) * kVec;  // channels staged
        const int c0 = u0 * kVec;
        const int cv = g.f1_vec ? 4 : 1;  // channels per copy
        for (int i = tid; i < kTile * cc / cv; i += kTileThreads) {
          const int p = i / (cc / cv);
          const int j = (i - p * (cc / cv)) * cv;
          if (!s_live[p]) continue;
          const int n = (ty0 + p / kTileW) * g.wq + tx0 + p % kTileW;
          float* dst = f1s + ((j / 4) * kTile + p) * 4 + j % 4;
          const float* src = a.f1 + (static_cast<size_t>(b) * N + n) * C + c0 + j;
          if (g.f1_vec)
            cp_async16(dst, src);
          else
            cp_async4(dst, src);
        }
      };

      // this thread's lattice row ky of pixel p: its kx range [klo, khi)
      // within the kx block from kx0 and the stage position of kx0
      auto range = [&](int p, int ky, int kx0, int& klo, int& khi, int& pos) {
        const int gx0 = s_gx0[p] + kx0;
        const int gy = s_gy0[p] + ky;
        const int ex = k1 - (s_fx[p] == 0.f ? 1 : 0);
        const int ey = k1 - (s_fy[p] == 0.f ? 1 : 0);
        klo = max(0, -gx0);
        khi = min(min(kMaxKx, ex - kx0), w2 - gx0);
        if (!s_live[p] || ky >= ey || gy < 0 || gy >= h2)
          khi = klo;  // nothing to dot: the row stays zero
        pos = (gy - by0) * bs + gx0 - bx0;
      };
      auto put = [&](int p, int ky, int kx0, const float* d, bool add) {
#pragma unroll
        for (int kx = 0; kx < kMaxKx; ++kx) {
          if (kx0 + kx >= k1) break;
          float* L = lattice + p * ls + ky * k1 + kx0 + kx;
          *L = add ? *L + d[kx] * inv_sqrt_c : d[kx] * inv_sqrt_c;
        }
      };

      for (int w0 = 0; w0 < items; w0 += kTileThreads) {
        // ---- this thread's (pixel pair, ky, kx block, half): the pair's
        // first 8 rows to 8 neighbouring lanes (one quarter-warp: 8 rows of
        // one column, 8 bank groups at the odd row stride), the other rows
        // two to a pair; half h dots units h, h + 2, ... of each chunk ----
        const int w = w0 + tid;
        const bool active = w < items;
        const int h = min(w / per_half, 1);
        const int wr = w % per_half;
        const int kx0 = wr / (kPairs * k1) * kMaxKx;
        const int jj = wr % (kPairs * k1);
        const int k8 = min(k1, 8);
        const int rest = max(k1 - k8, 1);
        const bool octet = jj < kPairs * k8;
        const int pp = octet ? jj / k8 : (jj - kPairs * k8) / rest;
        const int ky = octet ? jj % k8 : k8 + (jj - kPairs * k8) % rest;
        const int pa = 2 * pp;  // pixel (ty, 2i); pb = pa + 1 is (ty, 2i + 1)
        const int pb = pa + 1;
        int kloa, khia, posa, klob, khib, posb;
        range(pa, ky, kx0, kloa, khia, posa);
        range(pb, ky, kx0, klob, khib, posb);
        if (!active) {
          khia = kloa;
          khib = klob;
        }
        const bool fulla = kloa == 0 && khia == kMaxKx;
        const bool fullb = klob == 0 && khib == kMaxKx;
        // smooth flow: b's lattice row is a's shifted by one column, so one
        // run of kMaxKx + 1 positions feeds both (warp-uniform choice)
        const bool shared = __all_sync(
            0xffffffffu, !active || (fulla && fullb && posb == posa + 1));

        float da[kMaxKx], db[kMaxKx];
#pragma unroll
        for (int kx = 0; kx < kMaxKx; ++kx) da[kx] = db[kx] = 0.f;

        __syncthreads();  // a pass before is done with the stages
        for (int k = 0; k < kStages - 1; ++k) {
          if (k < chunks) stage(k, k);
          cp_async_commit();  // one group per chunk, empty past the end
        }
        for (int k = 0; k < chunks; ++k) {
          cp_async_wait<kStages - 2>();  // chunk k has landed
          __syncthreads();  // ... for every thread; chunk k-1 is dotted
          const int next = k + kStages - 1;
          if (next < chunks) stage(next, next % kStages);
          cp_async_commit();
          if (khia > kloa || khib > klob) {
            const unsigned char* base = stages + (k % kStages) * stage_bytes;
            const float4* f1s =
                reinterpret_cast<const float4*>(base + patch_bytes);
#pragma unroll
            for (int u = h; u < kUnits; u += 2) {
              if (k * kUnits + u >= units) break;
              float fa[kVec], fb[kVec];
#pragma unroll
              for (int j = 0; j < kVec / 4; ++j) {
                const float4 va = f1s[(u * (kVec / 4) + j) * kTile + pa];
                const float4 vb = f1s[(u * (kVec / 4) + j) * kTile + pb];
                fa[4 * j] = va.x;
                fa[4 * j + 1] = va.y;
                fa[4 * j + 2] = va.z;
                fa[4 * j + 3] = va.w;
                fb[4 * j] = vb.x;
                fb[4 * j + 1] = vb.y;
                fb[4 * j + 2] = vb.z;
                fb[4 * j + 3] = vb.w;
              }
              const uint4* src = reinterpret_cast<const uint4*>(base) + u * qmax;
              if (shared) {
                dot_pair<T>(src + posa, fa, fb, da, db);
              } else {
                if (fulla)
                  dot_row<T, true>(src + posa, fa, kloa, khia, da);
                else
                  dot_row<T, false>(src + posa, fa, kloa, khia, da);
                if (fullb)
                  dot_row<T, true>(src + posb, fb, klob, khib, db);
                else
                  dot_row<T, false>(src + posb, fb, klob, khib, db);
              }
            }
          }
        }
        cp_async_wait<0>();  // only empty groups are left
        // the two halves' sums: half 0 stores, half 1 adds
        if (active && h == 0) {
          put(pa, ky, kx0, da, false);
          put(pb, ky, kx0, db, false);
        }
        __syncthreads();
        if (active && h == 1) {
          put(pa, ky, kx0, da, true);
          put(pb, ky, kx0, db, true);
        }
      }
    } else {
      // ---- per-pixel branch: a warp per pixel, lanes across channels,
      // each in-frame lattice row read from global memory -----------------
      float* f1w = reinterpret_cast<float*>(stages) + warp * C;
      for (int p = warp; p < kTile; p += kTileWarps) {
        const bool live = s_live[p];
        if (live) {
          const int n = (ty0 + p / kTileW) * g.wq + tx0 + p % kTileW;
          const float* src = a.f1 + (static_cast<size_t>(b) * N + n) * C;
          for (int c = lane; c < C; c += 32) f1w[c] = src[c];
        }
        __syncwarp();
        const int gx0 = s_gx0[p];
        const int gy0 = s_gy0[p];
        for (int k0 = 0; k0 < k2; k0 += kUnroll) {
          const T* rows[kUnroll];
          float s[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int k = k0 + u;
            const int gx = gx0 + k % k1;
            const int gy = gy0 + k / k1;
            const bool ok =
                live && k < k2 && gx >= 0 && gx < w2 && gy >= 0 && gy < h2;
            rows[u] = ok ? f2 + ((static_cast<size_t>(b) * h2 + gy) * w2 + gx) *
                                    static_cast<size_t>(C)
                         : nullptr;
            s[u] = 0.f;
          }
          for (int c = lane * kVec; c < C; c += 32 * kVec) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
              if (rows[u] != nullptr) s[u] += Chunk<T>::dot(rows[u] + c, f1w + c);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float v = warp_sum(s[u]);
            if (lane == 0 && k0 + u < k2)
              lattice[p * ls + k0 + u] = v * inv_sqrt_c;
          }
        }
        __syncwarp();  // the next pixel's f1 row overwrites this one
      }
    }
    __syncthreads();

    // stage W_l's rows [c * g.wrows, ...) into buffer c & 1, after the window
    const float* wl = a.weight + static_cast<size_t>(l) * kk * F;
    auto stage_w = [&](int c) {
      float* dst = wbuf + (c & 1) * g.wrows * FS;
      const int t0 = c * g.wrows;
      const int rows = min(g.wrows, kk - t0);
      if (g.w_vec) {
        const int vecs = F / 4;
        for (int i = tid; i < rows * vecs; i += kTileThreads) {
          const int t = i / vecs;
          const int v = i - t * vecs;
          cp_async16(dst + t * FS + 4 * v,
                     wl + static_cast<size_t>(t0 + t) * F + 4 * v);
        }
      } else {
        for (int i = tid; i < rows * F; i += kTileThreads) {
          const int t = i / F;
          const int f = i - t * F;
          cp_async4(dst + t * FS + f, wl + static_cast<size_t>(t0 + t) * F + f);
        }
      }
      cp_async_commit();
    };
    stage_w(0);
    if (g.wrows < kk) stage_w(1);

    // ---- corner blend into window[t][p], x offset slow ---------------------
    for (int i = tid; i < kk * kTile; i += kTileThreads) {
      const int p = i % kTile;
      const int t = i / kTile;
      const int ix = t / win;
      const int iy = t % win;
      const float fx = s_fx[p];
      const float fy = s_fy[p];
      const float* L = lattice + p * ls + iy * k1 + ix;
      window[i] = (1.f - fy) * ((1.f - fx) * L[0] + fx * L[1]) +
                  fy * ((1.f - fx) * L[k1] + fx * L[k1 + 1]);
    }

    // ---- window @ W_l: 8 pixels (one tile row) x 4 features, FS / 4
    // apart, per thread (lanes on consecutive features: conflict-free W
    // reads and accumulator rows);
    // W's rows pass through shared memory g.wrows at a time, double-buffered
    // by cp.async (the first two chunks load during the blend) -------------
    const int fg = FS / 4;
    const int nwc = (kk + g.wrows - 1) / g.wrows;
    for (int c = 0; c < nwc; ++c) {
      if (c + 1 < nwc)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // W chunk c (and, first, the window) is in place
      const float* wc = wbuf + (c & 1) * g.wrows * FS;
      const int t0 = c * g.wrows;
      const int rows = min(g.wrows, kk - t0);
      for (int e = tid; e < kTileH * fg; e += kTileThreads) {
        const int ty = e / fg;
        const int fq = e % fg;
        float part[4][kTileW];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int x = 0; x < kTileW; ++x) part[j][x] = 0.f;
#pragma unroll 4
        for (int t = 0; t < rows; ++t) {
          const float* wt = wc + t * FS + fq;
          const float4* wr = reinterpret_cast<const float4*>(
              window + (t0 + t) * kTile + ty * kTileW);
          const float4 lo4 = wr[0];
          const float4 hi4 = wr[1];
          const float wx[kTileW] = {lo4.x, lo4.y, lo4.z, lo4.w,
                                    hi4.x, hi4.y, hi4.z, hi4.w};
          const float wf[4] = {wt[0], wt[fg], wt[2 * fg], wt[3 * fg]};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int x = 0; x < kTileW; ++x)
              part[j][x] = fmaf(wx[x], wf[j], part[j][x]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float4* ar = reinterpret_cast<float4*>(
              acc + (fq + j * fg) * kAccStride + ty * kTileW);
          float4 lo = ar[0];
          float4 hi = ar[1];
          lo.x += part[j][0];
          lo.y += part[j][1];
          lo.z += part[j][2];
          lo.w += part[j][3];
          hi.x += part[j][4];
          hi.y += part[j][5];
          hi.z += part[j][6];
          hi.w += part[j][7];
          ar[0] = lo;
          ar[1] = hi;
        }
      }
      if (c + 2 < nwc) {
        __syncthreads();  // every thread is done with buffer c & 1
        stage_w(c + 2);
      }
    }
  }
  __syncthreads();

  // ---- (B, F, H, W) out: a warp writes one feature's 4 rows of 8 -------
  for (int i = tid; i < F * kTile; i += kTileThreads) {
    const int f = i / kTile;
    const int p = i % kTile;
    const int y = ty0 + p / kTileW;
    const int x = tx0 + p % kTileW;
    const int n = y * g.wq + x;
    if (y < g.hq && x < g.wq && n < N)
      a.out[(static_cast<size_t>(b) * F + f) * N + n] = acc[f * kAccStride + p];
  }
}

template <typename T>
cudaError_t launch_fused(const FlashCorrArgs& a, cudaStream_t stream) {
  constexpr int kVec = Unit<T>::kVec;
  const size_t r = a.radius;
  const size_t k1 = 2 * r + 2;
  const size_t kk = (2 * r + 1) * (2 * r + 1);
  TileGeom g;
  if (a.h2[0] > 0 && a.w2[0] > 0 &&
      static_cast<long long>(a.h2[0]) * a.w2[0] == a.n) {
    g.hq = a.h2[0];
    g.wq = a.w2[0];
  } else {
    g.hq = 1;
    g.wq = a.n;
  }
  g.fs = (a.feat + 3) / 4 * 4;
  g.w_vec = a.feat % 4 == 0 &&
            reinterpret_cast<uintptr_t>(a.weight) % 16 == 0;
  g.f1_vec = reinterpret_cast<uintptr_t>(a.f1) % 16 == 0;  // C % 16 == 0
  // the stage region holds two stages (per_position bytes for each patch
  // position, f1_bytes of f1), and at other times the window or the
  // per-pixel branch's f1 rows; the rest is fixed
  const size_t per_position = kStages * kUnits * 16;
  const size_t f1_bytes = kStages * kUnits * kVec * kTile * 4;
  const size_t window = kk * kTile * 4;
  const size_t other = static_cast<size_t>(kTileThreads / 32) * a.c * 4;
  const size_t fixed = (k1 * k1 + 1) * kTile * 4 +
                       static_cast<size_t>(g.fs) * kAccStride * 4 +
                       5 * kTile * 4 + 8 * 4;
  size_t budget = kBudgetTwo;
  if (fixed + f1_bytes + per_position * k1 * k1 > budget) budget = kBudgetOne;
  if (fixed + f1_bytes > budget) return cudaErrorInvalidValue;
  g.qmax = static_cast<int>((budget - fixed - f1_bytes) / per_position) / 32 * 32;
  // ... and, in the epilogue, the window and two stages of W rows
  const size_t w_row = static_cast<size_t>(g.fs) * 4;
  const size_t region = std::max(std::max(per_position * g.qmax + f1_bytes, other),
                                 window + 2 * w_row);
  const int wmax = static_cast<int>((region - window) / (2 * w_row));
  const int wchunks = (static_cast<int>(kk) + wmax - 1) / wmax;
  g.wrows = (static_cast<int>(kk) + wchunks - 1) / wchunks;
  g.stages_bytes = static_cast<int>(region);
  const size_t bytes = g.stages_bytes + fixed;
  if (bytes > kBudgetOne) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fused_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_fused_tile_kernel<T>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((g.wq + kTileW - 1) / kTileW, (g.hq + kTileH - 1) / kTileH,
                  a.batch);
  flash_fused_tile_kernel<T><<<grid, kTileThreads, bytes, stream>>>(a, g);
  return cudaGetLastError();
}

}  // namespace

cudaError_t flash_corr_launch(const FlashCorrArgs& args, int dtype, bool fused,
                              cudaStream_t stream) {
  switch (dtype) {
    case FLASH_FP32:
      return fused ? launch_fused<float>(args, stream)
                   : launch_lookup<float>(args, stream);
    case FLASH_BF16:
      return fused ? launch_fused<__nv_bfloat16>(args, stream)
                   : launch_lookup<__nv_bfloat16>(args, stream);
    case FLASH_INT8:
      return fused ? launch_fused<int8_t>(args, stream)
                   : launch_lookup<int8_t>(args, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
