// Shared declarations of the per-pixel correlation kernel (pallas_corr.cu)
// and its plain C binding (pallas_corr.cpp).
#pragma once

#include <cuda_runtime.h>

#define PALLAS_CORR_MAX_LEVELS 8

// storage dtype codes of the fmap2 levels (the Python wrapper's codes)
enum PallasCorrDtype { PALLAS_FP32 = 0, PALLAS_BF16 = 1, PALLAS_INT8 = 2 };

struct PallasCorrArgs {
  const float* f1;      // (B, N, C) fp32 query features
  const float* coords;  // (B, N, 2) fp32 centers (x, y); scaled per level
  const float* weight;  // fused: (L * K, F) fp32, K = (2r+1)^2
  const float* bias;    // fused: (F,) fp32
  float* out;           // fused: (B, F, N); lookup: (B, L * K, N)
  const void* level[PALLAS_CORR_MAX_LEVELS];  // (B, h2, w2, C) storage dtype
  int h2[PALLAS_CORR_MAX_LEVELS];
  int w2[PALLAS_CORR_MAX_LEVELS];
  float coord_scale[PALLAS_CORR_MAX_LEVELS];  // level centers = coords * s
  int num_levels;
  int batch;
  int n;       // query pixels per batch item (H * W)
  int c;       // channels; a multiple of 16
  int radius;
  int feat;    // F (fused only)
  int pixels;  // query pixels per block (set by pallas_corr_launch)
};

// Launch on `stream`; returns the launch's cudaError_t (no synchronise).
cudaError_t pallas_corr_launch(PallasCorrArgs args, int dtype, bool fused,
                               cudaStream_t stream);
