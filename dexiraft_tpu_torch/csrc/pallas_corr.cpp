// Plain C binding of the per-pixel correlation kernel (pallas_corr.cu),
// loaded from Python with ctypes (dexiraft_tpu_torch/ops/corr_kernels.py).
// It includes no PyTorch header, so the whole library builds with one nvcc
// call in seconds. Pointers are device pointers from tensor.data_ptr(); the
// Python wrapper has already checked devices, dtypes, shapes and
// contiguity, and this layer re-checks what would make the kernel read out
// of bounds.

#include <stdint.h>

#include "pallas_corr.h"

namespace {
constexpr int kBadArgument = -1;
}

extern "C" {

// Returns 0 on success, -1 for an argument the kernel does not take, or the
// cudaError_t of the launch.
int dexiraft_pallas_corr(const void* f1, const void* coords, const void* weight,
                         const void* bias, void* out, const void* const* levels,
                         const int* h2, const int* w2, const float* coord_scale,
                         int num_levels, int batch, int n, int c, int radius,
                         int feat, int dtype, int fused, void* stream) {
  if (num_levels < 1 || num_levels > PALLAS_CORR_MAX_LEVELS || batch < 1 ||
      n < 1 || c < 16 || c % 16 != 0 || radius < 0 || radius > 8 ||
      dtype < PALLAS_FP32 || dtype > PALLAS_INT8 || f1 == nullptr ||
      coords == nullptr || out == nullptr) {
    return kBadArgument;
  }
  if (fused && (feat < 1 || weight == nullptr || bias == nullptr)) {
    return kBadArgument;
  }
  PallasCorrArgs a = {};
  a.f1 = static_cast<const float*>(f1);
  a.coords = static_cast<const float*>(coords);
  a.weight = static_cast<const float*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  for (int l = 0; l < num_levels; ++l) {
    if (h2[l] < 0 || w2[l] < 0) return kBadArgument;
    if (h2[l] > 0 && w2[l] > 0 && levels[l] == nullptr) return kBadArgument;
    a.level[l] = levels[l];
    a.h2[l] = h2[l];
    a.w2[l] = w2[l];
    a.coord_scale[l] = coord_scale[l];
  }
  a.num_levels = num_levels;
  a.batch = batch;
  a.n = n;
  a.c = c;
  a.radius = radius;
  a.feat = fused ? feat : 0;
  return static_cast<int>(pallas_corr_launch(
      a, dtype, fused != 0, static_cast<cudaStream_t>(stream)));
}

const char* dexiraft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
