// Shared declarations of the tile-shared correlation kernel (pallas_corr.cu)
// and its plain C binding (pallas_corr.cpp).
#pragma once

#include <cuda_runtime.h>

#define PALLAS_CORR_MAX_LEVELS 8

// storage dtype codes of the fmap2 levels (the Python wrapper's codes)
enum PallasCorrDtype { PALLAS_FP32 = 0, PALLAS_BF16 = 1, PALLAS_INT8 = 2 };

// pallas_corr_launch's own failures, beside the cudaError_t codes (> 0)
enum PallasCorrStatus {
  // cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled
  PALLAS_NO_TENSOR_MAP_ENCODER = -2,
  // cuTensorMapEncodeTiled refused a map: the CUresult is
  // PALLAS_TENSOR_MAP_FAILED - status
  PALLAS_TENSOR_MAP_FAILED = -1000,
};

struct PallasCorrArgs {
  const float* f1;      // (B, H, W, C) fp32 query features
  const float* coords;  // (B, H, W, 2) fp32 centers (x, y); scaled per level
  const float* weight;  // fused: (L * K, F) fp32, K = (2r+1)^2
  const float* bias;    // fused: (F,) fp32
  float* out;           // fused: (B, F, H*W); lookup: (B, L * K, H*W)
  const void* level[PALLAS_CORR_MAX_LEVELS];  // (B, h2, w2, C) storage dtype
  int h2[PALLAS_CORR_MAX_LEVELS];
  int w2[PALLAS_CORR_MAX_LEVELS];
  float coord_scale[PALLAS_CORR_MAX_LEVELS];  // level centers = coords * s
  int num_levels;
  int batch;
  int hq;      // the query grid: H rows ...
  int wq;      // ... of W pixels
  int c;       // channels; a multiple of 16
  int radius;
  int feat;    // F (fused only)
};

// Encode the tensor maps and launch on `stream`; returns 0, a
// PallasCorrStatus, or the launch's cudaError_t (no synchronise).
int pallas_corr_launch(const PallasCorrArgs& args, int dtype, bool fused,
                       cudaStream_t stream);

// The most box positions (columns x rows, the rows rounded up to the TMA
// box height) that a tile stages at once for these arguments; a larger box
// takes the per-pixel branch. 0 when the arguments do not fit.
int pallas_corr_box_limit(int dtype, bool fused, int radius, int c, int feat);
