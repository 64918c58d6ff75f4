// Shared declarations of the flash correlation kernel (flash_corr.cu) and
// its plain C binding (flash_corr.cpp).
#pragma once

#include <cuda_runtime.h>

#define FLASH_CORR_MAX_LEVELS 8

// storage dtype codes of the fmap2 levels (the Python wrapper's codes)
enum FlashCorrDtype { FLASH_FP32 = 0, FLASH_BF16 = 1, FLASH_INT8 = 2 };

struct FlashCorrArgs {
  const float* f1;      // (B, N, C) fp32 query features
  const float* coords;  // (B, N, 2) fp32 centers (x, y); scaled per level
  const float* weight;  // fused: (L * K, F) fp32, K = (2r+1)^2
  const float* bias;    // fused: (F,) fp32
  float* out;           // fused: (B, F, N); lookup: (B, L * K, N)
  const void* level[FLASH_CORR_MAX_LEVELS];  // (B, h2, w2, C) storage dtype
  int h2[FLASH_CORR_MAX_LEVELS];
  int w2[FLASH_CORR_MAX_LEVELS];
  float coord_scale[FLASH_CORR_MAX_LEVELS];  // level centers = coords * s
  int num_levels;
  int batch;
  int n;       // query pixels per batch item (H * W)
  int c;       // channels; a multiple of 16
  int radius;
  int feat;    // F (fused only)
};

// Launch on `stream`; returns the launch's cudaError_t (no synchronise).
cudaError_t flash_corr_launch(const FlashCorrArgs& args, int dtype, bool fused,
                              cudaStream_t stream);
