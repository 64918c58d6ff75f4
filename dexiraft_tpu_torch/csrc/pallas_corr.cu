// Tile-shared correlation lookup for Hopper (sm_90a), fed by TMA: B3
// pallas_fused_step and B4 pallas_local_corr_level of the PyTorch port.
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
// the (2r+1)^2 window in the reference's channel order (x offset on the slow
// axis: index = ix * (2r+1) + iy). Int8 scales are not applied here: the
// caller folds them into W (fused) or multiplies the window (lookup), as the
// JAX code does.
//
// Bound. At the v5 shape (dual stream, batch 2 x 55x128 queries, C=256, 4
// levels, r=4, F=256) one fused call needs ~4.5 GFLOP of fp32 arithmetic
// (lattice dots, blend, window @ W) against ~48 MB of compulsory traffic:
// bound by operations on the fp32 CUDA cores (every product has an fp32
// operand), ~67 us at the published peak; one lookup level is bound by its
// bytes (~10 us at level 0). The first port of this kernel staged every
// pixel's 100 lattice rows anew for each 16-channel chunk (~5.8 GB of
// L2->SM traffic per fused call, a synchronous load, divisions and an
// in-frame test per 16 bytes). This design shares what neighbouring pixels
// share and hands the staging to the Tensor Memory Accelerator:
//   * a CTA of 320 threads owns a 4x8 tile of query pixels of one batch
//     item (448 CTAs at v5's batch 2, two per SM);
//   * per level, warp 0 clips and floors each pixel's center and takes the
//     bounding box of the live pixels' full (2r+2)^2 lattices, NOT clipped
//     to the frame. A pixel whose effective lattice (the rows and columns
//     its blend weighs nonzero) misses the frame is left out (far or NaN
//     coords, a tail pixel): its window is zero. A tile with no live pixel
//     skips the level (the lookup writes zeros). A 0-row or 0-column level
//     has no tensor map and is always skipped;
//   * patch branch (box <= 32 columns and <= qmax positions): the box is
//     staged channel chunk by chunk, 32 bytes of channels per position (8
//     fp32, 16 bf16 or 32 int8 channels), by cp.async.bulk.tensor from a
//     4-D CUtensorMap over the (B, h2, w2, C) level. A map's box is fixed,
//     so each level has three maps, 16, 24 and 32 columns wide by 2 rows,
//     and a tile takes the narrowest that spans its box, in as many 2-row
//     copies as its box has rows. TMA fills every element outside the
//     frame with zeros, negative coordinates included: the dots read the
//     box with no in-frame test and no index arithmetic beyond one
//     multiply-add. The maps swizzle 32-byte rows (SWIZZLE_32B), so 8
//     consecutive positions of one unit fall in 8 bank groups. f1's chunk
//     of the tile rides in the same stage through a second map. One thread
//     issues the copies into a ring of two stages with mbarrier transaction
//     counts: chunk k+1 lands while chunk k is dotted (a deeper ring for
//     the smaller boxes measured no faster);
//   * patch dots on the fp32 CUDA cores: a thread owns pixel p's lattice
//     column kx and keeps its 2r+2 row sums in registers across the chunks
//     (the lanes of a warp run over consecutive columns); values are upcast
//     from the storage dtype as they are read from shared memory;
//   * per-pixel branch (a wider or taller box: a flow discontinuity,
//     scattered coords): a warp per pixel reads the pixel's in-frame lattice
//     rows from global memory, chosen per (tile, level) from the data. Both
//     branches compute the same sums;
//   * FUSED: the corner blend writes the (kk, 32) window into the idle stage
//     region; W_l's rows follow it there through cp.async, double-buffered,
//     so W is read once per tile and level; each thread takes 8 pixels (one
//     tile row) x 4 features; the [F][36] accumulator starts at the bias and
//     lives in shared memory across levels; only (B, F, H, W) is written.
//     !FUSED: the blend writes (B, L*kk, H*W), consecutive threads on
//     consecutive pixels.
// No path falls back quietly: a tensor map the driver refuses is returned
// to the caller as an error.

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "pallas_corr.h"

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 8;
constexpr int kTile = kTileH * kTileW;  // 32 query pixels: one per lane
constexpr int kThreads = 320;           // r=4: 32 pixels x 10 columns
constexpr int kMaxKy = 10;              // row sums per thread and pass
constexpr int kPosBytes = 32;           // channel bytes per position/stage
constexpr int kBoxRows = 2;             // rows of one TMA box
constexpr int kNumWidths = 3;          // TMA box columns: 16, 24, 32
constexpr int kBudgetTwo = 113 * 1024;  // dynamic smem per CTA, 2 per SM
constexpr int kBudgetOne = 227 * 1024;  // the most one CTA may take
constexpr int kAccStride = kTile + 4;   // accumulator row of one feature
constexpr int kAlign = 1024;            // stage alignment (swizzle atoms)
constexpr int kStages = 2;              // TMA ring depth

__host__ __device__ constexpr int box_width(int wi) { return 16 + 8 * wi; }

enum TileMode { kDead = 0, kPatch = 1, kPerPixel = 2 };

// the tensor maps of one call: three box widths per level, and f1
struct alignas(64) TensorMaps {
  CUtensorMap f2[PALLAS_CORR_MAX_LEVELS][kNumWidths];
  CUtensorMap f1;
};

struct TileGeom {
  int qmax;          // box positions a stage holds
  int f2_bytes;      // a stage's f2 part (a multiple of kAlign)
  int stage_bytes;   // one stage: f2 part, then f1's chunk
  int region_bytes;  // the stage region (two stages, or the epilogue's)
  int fs;            // F rounded up to 4: a W row in shared memory
  int wrows;         // W rows per epilogue stage
  bool w_vec;        // W rows may be copied as float4s
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// order this thread's generic-proxy shared-memory writes before the async
// proxy's (TMA) writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one 4-D box (c, x, y, b) of `map` into shared memory at `dst`; completes
// its bytes on `bar`. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c, int x, int y, int b,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// the 16-byte unit u (0 or 1) of box position q in a stage written by a
// SWIZZLE_32B map: byte bit 4 is XORed with byte bit 7
__device__ __forceinline__ uint4 staged_unit(const unsigned char* stage, int q,
                                             int u) {
  const int off = q * kPosBytes + ((u ^ ((q >> 2) & 1)) << 4);
  return *reinterpret_cast<const uint4*>(stage + off);
}

template <typename T, bool FUSED>
__global__ void __launch_bounds__(kThreads, 2)
pallas_tile_kernel(const PallasCorrArgs a, const TileGeom g,
                   const __grid_constant__ TensorMaps maps) {
  constexpr int kVec = Unit<T>::kVec;
  constexpr int kCpc = kPosBytes / static_cast<int>(sizeof(T));  // ch/chunk
  constexpr int kWarps = kThreads / 32;
  const int r = a.radius;
  const int win = 2 * r + 1;
  const int kk = win * win;
  const int k1 = 2 * r + 2;
  const int k2 = k1 * k1;
  const int C = a.c;
  const int N = a.hq * a.wq;
  const int F = a.feat;
  const int FS = g.fs;
  const int chunks = C / kCpc;
  const int kyb = (k1 + kMaxKy - 1) / kMaxKy;  // row blocks per column
  const int items = kTile * kyb * k1;          // (pixel, row block, column)
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float inv_sqrt_c = rsqrtf(static_cast<float>(C));

  // shared memory (from a kAlign boundary): the stage region (two stages
  // [f2 box | f1 chunk]; between levels the window and W rows, or the
  // per-pixel branch's f1 rows, alias it), two mbarriers, lattice dots
  // [32][k2 + 1], accumulator [FS][36] (FUSED), per-pixel fraction /
  // origin / liveness, the tile's box
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* region =
      smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(region + g.region_bytes);
  float* lattice = reinterpret_cast<float*>(bars + kStages);
  const int ls = k2 + 1;  // lattice row stride
  float* acc = lattice + kTile * ls;                    // [FS][kAccStride]
  float* s_fx = acc + (FUSED ? FS * kAccStride : 0);
  float* s_fy = s_fx + kTile;
  int* s_gx0 = reinterpret_cast<int*>(s_fy + kTile);
  int* s_gy0 = s_gx0 + kTile;
  int* s_live = s_gy0 + kTile;
  int* s_box = s_live + kTile;  // mode, bx0, by0, width index, box rows
  float* window = reinterpret_cast<float*>(region);   // [kk][32]
  float* wbuf = window + kk * kTile;  // W rows: 2 x [g.wrows][FS]
  const uint32_t bar0 = smem_addr(bars);
  const uint32_t region_s = smem_addr(region);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (FUSED) {
    for (int i = tid; i < FS * kTile; i += kThreads) {
      const int f = i / kTile;
      acc[f * kAccStride + i % kTile] = f < F ? a.bias[f] : 0.f;
    }
  }
  uint32_t phase = 0;  // bit s: the parity stage s's barrier waits for next

  for (int l = 0; l < a.num_levels; ++l) {
    const int h2 = a.h2[l];
    const int w2 = a.w2[l];
    if (FUSED && (h2 == 0 || w2 == 0)) continue;  // contributes nothing
    __syncthreads();  // the last level is done with the region and lattice

    // ---- warp 0: clip, floor, fraction, liveness; the tile's box ---------
    if (warp == 0) {
      const int p = lane;
      const int y = ty0 + p / kTileW;
      const int x = tx0 + p % kTileW;
      const bool valid = y < a.hq && x < a.wq;
      float cx = -1e30f, cy = -1e30f;  // padded tail pixel: all-zero window
      if (valid) {
        const float* co =
            a.coords + (static_cast<size_t>(b) * N + y * a.wq + x) * 2;
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
      // (a 0-row or 0-column level has no live pixel and no tensor map)
      const bool live = valid && h2 > 0 && w2 > 0 && gx0 + ex > 0 &&
                        gx0 < w2 && gy0 + ey > 0 && gy0 < h2;
      s_fx[p] = fx;
      s_fy[p] = fy;
      s_gx0[p] = gx0;
      s_gy0[p] = gy0;
      s_live[p] = live;
      // the box of the live pixels' whole lattices, frame or not: TMA
      // stages what lies outside the frame as zeros
      const unsigned all = 0xffffffffu;
      const int bx0 = __reduce_min_sync(all, live ? gx0 : INT32_MAX);
      const int bx1 = __reduce_max_sync(all, live ? gx0 + k1 : INT32_MIN);
      const int by0 = __reduce_min_sync(all, live ? gy0 : INT32_MAX);
      const int by1 = __reduce_max_sync(all, live ? gy0 + k1 : INT32_MIN);
      const bool any = __any_sync(all, live);
      if (p == 0) {
        int mode = kDead;
        int wi = 0;
        int rows = 0;
        if (any) {
          const int bw = bx1 - bx0;
          rows = (by1 - by0 + kBoxRows - 1) / kBoxRows * kBoxRows;
          while (wi < kNumWidths && box_width(wi) < bw) ++wi;
          mode = wi < kNumWidths && rows * box_width(wi) <= g.qmax ? kPatch
                                                                   : kPerPixel;
        }
        s_box[0] = mode;
        s_box[1] = bx0;
        s_box[2] = by0;
        s_box[3] = wi;
        s_box[4] = rows;
      }
    }
    __syncthreads();
    const int mode = s_box[0];
    if (mode == kDead) {  // every window of the tile is zero at this level
      if (!FUSED) {
        for (int i = tid; i < kk * kTile; i += kThreads) {
          const int p = i % kTile;
          const int t = i / kTile;
          const int y = ty0 + p / kTileW;
          const int x = tx0 + p % kTileW;
          if (y < a.hq && x < a.wq)
            a.out[(static_cast<size_t>(b) * a.num_levels * kk + l * kk + t) *
                      N + y * a.wq + x] = 0.f;
        }
      }
      continue;
    }

    if (mode == kPatch) {
      const int bx0 = s_box[1];
      const int by0 = s_box[2];
      const int wi = s_box[3];
      const int bw = box_width(wi);  // row stride of the staged box
      const int nbox = s_box[4] / kBoxRows;
      const uint32_t box_bytes = bw * kBoxRows * kPosBytes;
      const uint32_t tx_bytes = nbox * box_bytes + kTile * kCpc * 4;
      const CUtensorMap* m2 = &maps.f2[l][wi];

      // thread 0: chunk k (channels [k * kCpc, ...)) of the box and of f1
      // into stage s
      auto issue = [&](int k, int s) {
        const uint32_t bar = bar0 + 8 * s;
        const uint32_t dst = region_s + s * g.stage_bytes;
        mbar_expect_tx(bar, tx_bytes);
        for (int j = 0; j < nbox; ++j)
          tma_load_4d(dst + j * box_bytes, m2, k * kCpc, bx0,
                      by0 + j * kBoxRows, b, bar);
        tma_load_4d(dst + g.f2_bytes, &maps.f1, k * kCpc, tx0, ty0, b, bar);
      };

      const int oct = k1 / 8 * 8;             // columns in whole octets
      const int full = kTile * kyb * oct;     // items of those octets
      for (int w0 = 0; w0 < items; w0 += kThreads) {
        // ---- this thread's (pixel, row block, column): the columns of a
        // pixel's whole octets go 8 to a quarter-warp (8 consecutive box
        // positions: 8 bank groups), the rest (columns 8 and 9 at r=4) are
        // packed after them --------------------------------------------------
        const int w = w0 + tid;
        const bool active = w < items;
        int kx = 0, pr = 0;
        if (w < full) {
          const int t = w / 8;
          pr = t / (oct / 8);
          kx = t % (oct / 8) * 8 + w % 8;
        } else if (active) {  // then k1 - oct > 0
          pr = (w - full) / (k1 - oct);
          kx = oct + (w - full) % (k1 - oct);
        }
        const int p = pr / kyb;
        const int ky0 = (pr % kyb) * kMaxKy;
        const bool go = active && s_live[p];
        const int q0 = (s_gy0[p] + ky0 - by0) * bw + s_gx0[p] + kx - bx0;
        float sum[kMaxKy];
#pragma unroll
        for (int j = 0; j < kMaxKy; ++j) sum[j] = 0.f;

        __syncthreads();  // every thread is done with the stages
        if (tid == 0) {
          fence_proxy_async();  // the region's generic writes come first
          for (int k = 0; k < kStages && k < chunks; ++k) issue(k, k);
        }
        for (int k = 0; k < chunks; ++k) {
          const int s = k % kStages;
          mbar_wait(bar0 + 8 * s, (phase >> s) & 1);
          phase ^= 1u << s;
          if (go) {
            const unsigned char* st = region + s * g.stage_bytes;
            const float4* f1v =
                reinterpret_cast<const float4*>(st + g.f2_bytes) + p * (kCpc / 4);
            float f[kCpc];
#pragma unroll
            for (int j = 0; j < kCpc / 4; ++j) {
              const float4 v = f1v[j];
              f[4 * j] = v.x;
              f[4 * j + 1] = v.y;
              f[4 * j + 2] = v.z;
              f[4 * j + 3] = v.w;
            }
#pragma unroll
            for (int ky = 0; ky < kMaxKy; ++ky) {
              if (ky0 + ky < k1) {
                const int q = q0 + ky * bw;
                sum[ky] = Unit<T>::fma(staged_unit(st, q, 0), f, sum[ky]);
                sum[ky] = Unit<T>::fma(staged_unit(st, q, 1), f + kVec, sum[ky]);
              }
            }
          }
          __syncthreads();  // every thread is done with stage s
          if (tid == 0 && k + kStages < chunks) issue(k + kStages, s);
        }
        if (active) {
#pragma unroll
          for (int ky = 0; ky < kMaxKy; ++ky)
            if (ky0 + ky < k1)
              lattice[p * ls + (ky0 + ky) * k1 + kx] = sum[ky] * inv_sqrt_c;
        }
      }
    } else {
      // ---- per-pixel branch: a warp per pixel, lanes across channels,
      // each in-frame lattice row read from global memory -----------------
      const T* f2 = static_cast<const T*>(a.level[l]);
      float* f1w = reinterpret_cast<float*>(region) + warp * C;
      constexpr int kUnroll = 4;
      for (int p = warp; p < kTile; p += kWarps) {
        const bool live = s_live[p];
        if (live) {
          const int n = (ty0 + p / kTileW) * a.wq + tx0 + p % kTileW;
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
              if (rows[u] != nullptr)
                s[u] = Unit<T>::fma(__ldg(reinterpret_cast<const uint4*>(rows[u] + c)),
                                    f1w + c, s[u]);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float v = warp_sum(s[u]);
            if (lane == 0 && k0 + u < k2) lattice[p * ls + k0 + u] = v * inv_sqrt_c;
          }
        }
        __syncwarp();  // the next pixel's f1 row overwrites this one
      }
    }
    __syncthreads();

    if (!FUSED) {
      // ---- corner blend straight out, x offset slow; pixel index fastest
      for (int i = tid; i < kk * kTile; i += kThreads) {
        const int p = i % kTile;
        const int t = i / kTile;
        const int y = ty0 + p / kTileW;
        const int x = tx0 + p % kTileW;
        if (y >= a.hq || x >= a.wq) continue;
        const int ix = t / win;
        const int iy = t % win;
        const float fx = s_fx[p];
        const float fy = s_fy[p];
        const float* L = lattice + p * ls + iy * k1 + ix;
        a.out[(static_cast<size_t>(b) * a.num_levels * kk + l * kk + t) * N +
              y * a.wq + x] = (1.f - fy) * ((1.f - fx) * L[0] + fx * L[1]) +
                              fy * ((1.f - fx) * L[k1] + fx * L[k1 + 1]);
      }
      continue;
    }

    // stage W_l's rows [c * g.wrows, ...) into buffer c & 1, after the window
    const float* wl = a.weight + static_cast<size_t>(l) * kk * F;
    auto stage_w = [&](int c) {
      float* dst = wbuf + (c & 1) * g.wrows * FS;
      const int t0 = c * g.wrows;
      const int rows = min(g.wrows, kk - t0);
      if (g.w_vec) {
        const int vecs = F / 4;
        for (int i = tid; i < rows * vecs; i += kThreads) {
          const int t = i / vecs;
          const int v = i - t * vecs;
          cp_async16(dst + t * FS + 4 * v,
                     wl + static_cast<size_t>(t0 + t) * F + 4 * v);
        }
      } else {
        for (int i = tid; i < rows * F; i += kThreads) {
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
    for (int i = tid; i < kk * kTile; i += kThreads) {
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
    // reads and accumulator rows); W's rows pass through shared memory
    // g.wrows at a time, double-buffered by cp.async ------------------------
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
      for (int e = tid; e < kTileH * fg; e += kThreads) {
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

  if (FUSED) {
    __syncthreads();
    // ---- (B, F, H, W) out: a warp writes one feature's 4 rows of 8 -------
    for (int i = tid; i < F * kTile; i += kThreads) {
      const int f = i / kTile;
      const int p = i % kTile;
      const int y = ty0 + p / kTileW;
      const int x = tx0 + p % kTileW;
      if (y < a.hq && x < a.wq)
        a.out[(static_cast<size_t>(b) * F + f) * N + y * a.wq + x] =
            acc[f * kAccStride + p];
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda), looked up once
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 4-D map over a (B, H, W, C) tensor, C innermost; boxes of
// (box_c, box_x, box_y, 1), zeros outside the tensor
CUresult encode_4d(EncodeTiled encode, CUtensorMap* map, const void* base,
                   CUtensorMapDataType type, int elem_bytes, int batch, int h,
                   int w, int c, int box_c, int box_x, int box_y,
                   CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(c) * elem_bytes;
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_x),
                             static_cast<cuuint32_t>(box_y), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T>
struct MapType;
template <>
struct MapType<float> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct MapType<int8_t> {  // the int8 bits, reinterpreted on read
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

// The shared-memory plan of one call: the stage region, its box capacity
// and the epilogue's W rows; returns the bytes a CTA takes, or 0 when the
// arguments do not fit.
template <typename T, bool FUSED>
size_t tile_geom(const PallasCorrArgs& a, TileGeom* geom) {
  constexpr int kCpc = kPosBytes / static_cast<int>(sizeof(T));
  const size_t r = a.radius;
  const size_t k1 = 2 * r + 2;
  const size_t kk = (2 * r + 1) * (2 * r + 1);
  TileGeom g;
  g.fs = FUSED ? (a.feat + 3) / 4 * 4 : 0;
  g.w_vec = FUSED && a.feat % 4 == 0 &&
            reinterpret_cast<uintptr_t>(a.weight) % 16 == 0;
  // fixed: mbarriers, lattice, accumulator, per-pixel values and the box
  const size_t fixed = 8 * kStages + (k1 * k1 + 1) * kTile * 4 +
                       static_cast<size_t>(g.fs) * kAccStride * 4 +
                       5 * kTile * 4 + 8 * 4;
  const size_t f1_bytes = round_up(static_cast<size_t>(kTile) * kCpc * 4, kAlign);
  // two stages of f2 box + f1 chunk; a stage takes at least one lattice
  // in the widest box
  const size_t least =
      round_up(box_width(kNumWidths - 1) * (k1 + 1) * kPosBytes, kAlign) +
      f1_bytes;
  size_t budget = kBudgetTwo;
  if (fixed + kAlign + 2 * least > budget) budget = kBudgetOne;
  if (fixed + kAlign + 2 * least > budget) return 0;
  const size_t half = (budget - fixed - kAlign) / 2;
  g.f2_bytes = static_cast<int>((half - f1_bytes) / kAlign * kAlign);
  g.qmax = g.f2_bytes / kPosBytes;
  g.stage_bytes = g.f2_bytes + static_cast<int>(f1_bytes);
  // the region also holds the per-pixel branch's f1 rows, and the window
  // with two stages of W rows
  size_t region = std::max(2 * static_cast<size_t>(g.stage_bytes),
                           static_cast<size_t>(kThreads / 32) * a.c * 4);
  g.wrows = 0;
  if (FUSED) {
    const size_t window = kk * kTile * 4;
    const size_t w_row = static_cast<size_t>(g.fs) * 4;
    region = std::max(region, window + 2 * w_row);
    const int wmax = static_cast<int>((region - window) / (2 * w_row));
    const int wchunks = (static_cast<int>(kk) + wmax - 1) / wmax;
    g.wrows = (static_cast<int>(kk) + wchunks - 1) / wchunks;
  }
  g.region_bytes = static_cast<int>(round_up(region, 16));
  const size_t bytes = kAlign + g.region_bytes + fixed;
  if (bytes > kBudgetOne) return 0;
  *geom = g;
  return bytes;
}

template <typename T, bool FUSED>
int launch(const PallasCorrArgs& a, cudaStream_t stream) {
  constexpr int kCpc = kPosBytes / static_cast<int>(sizeof(T));
  TileGeom g;
  const size_t bytes = tile_geom<T, FUSED>(a, &g);
  if (bytes == 0 || a.c % kCpc != 0) return cudaErrorInvalidValue;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return PALLAS_NO_TENSOR_MAP_ENCODER;
  TensorMaps maps;  // filled per call; passed by value at launch
  memset(&maps, 0, sizeof(maps));
  for (int l = 0; l < a.num_levels; ++l) {
    if (a.h2[l] == 0 || a.w2[l] == 0) continue;  // never staged
    for (int wi = 0; wi < kNumWidths; ++wi) {
      const CUresult res = encode_4d(
          encode, &maps.f2[l][wi], a.level[l], MapType<T>::kType, sizeof(T),
          a.batch, a.h2[l], a.w2[l], a.c, kCpc, box_width(wi), kBoxRows,
          CU_TENSOR_MAP_SWIZZLE_32B);
      if (res != CUDA_SUCCESS) return PALLAS_TENSOR_MAP_FAILED - res;
    }
  }
  const CUresult res =
      encode_4d(encode, &maps.f1, a.f1, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                a.batch, a.hq, a.wq, a.c, kCpc, kTileW, kTileH,
                CU_TENSOR_MAP_SWIZZLE_NONE);
  if (res != CUDA_SUCCESS) return PALLAS_TENSOR_MAP_FAILED - res;

  auto kernel = pallas_tile_kernel<T, FUSED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.wq + kTileW - 1) / kTileW, (a.hq + kTileH - 1) / kTileH,
                  a.batch);
  kernel<<<grid, kThreads, bytes, stream>>>(a, g, maps);
  return cudaGetLastError();
}

template <bool FUSED>
int box_limit_dtype(const PallasCorrArgs& a, int dtype) {
  TileGeom g;
  size_t bytes = 0;
  switch (dtype) {
    case PALLAS_FP32: bytes = tile_geom<float, FUSED>(a, &g); break;
    case PALLAS_BF16: bytes = tile_geom<__nv_bfloat16, FUSED>(a, &g); break;
    case PALLAS_INT8: bytes = tile_geom<int8_t, FUSED>(a, &g); break;
    default: return 0;
  }
  return bytes == 0 ? 0 : g.qmax;
}

template <bool FUSED>
int launch_dtype(const PallasCorrArgs& a, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case PALLAS_FP32: return launch<float, FUSED>(a, stream);
    case PALLAS_BF16: return launch<__nv_bfloat16, FUSED>(a, stream);
    case PALLAS_INT8: return launch<int8_t, FUSED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

int pallas_corr_launch(const PallasCorrArgs& args, int dtype, bool fused,
                       cudaStream_t stream) {
  return fused ? launch_dtype<true>(args, dtype, stream)
               : launch_dtype<false>(args, dtype, stream);
}

int pallas_corr_box_limit(int dtype, bool fused, int radius, int c, int feat) {
  PallasCorrArgs a = {};
  a.radius = radius;
  a.c = c;
  a.feat = feat;
  return fused ? box_limit_dtype<true>(a, dtype)
               : box_limit_dtype<false>(a, dtype);
}
