// Plain C binding of the tile-shared correlation kernel (pallas_corr.cu),
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

// Returns 0 on success, -1 for an argument the kernel does not take, another
// PallasCorrStatus when a tensor map cannot be encoded, or the cudaError_t
// of the launch.
int dexiraft_pallas_corr(const void* f1, const void* coords, const void* weight,
                         const void* bias, void* out, const void* const* levels,
                         const int* h2, const int* w2, const float* coord_scale,
                         int num_levels, int batch, int hq, int wq, int c,
                         int radius, int feat, int dtype, int fused,
                         void* stream) {
  if (num_levels < 1 || num_levels > PALLAS_CORR_MAX_LEVELS || batch < 1 ||
      hq < 1 || wq < 1 || c < 16 || c % 16 != 0 || radius < 0 || radius > 8 ||
      dtype < PALLAS_FP32 || dtype > PALLAS_INT8 || f1 == nullptr ||
      coords == nullptr || out == nullptr ||
      reinterpret_cast<uintptr_t>(f1) % 16 != 0) {
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
    if (h2[l] > 0 && w2[l] > 0 &&
        (levels[l] == nullptr ||
         reinterpret_cast<uintptr_t>(levels[l]) % 16 != 0)) {
      return kBadArgument;
    }
    a.level[l] = levels[l];
    a.h2[l] = h2[l];
    a.w2[l] = w2[l];
    a.coord_scale[l] = coord_scale[l];
  }
  a.num_levels = num_levels;
  a.batch = batch;
  a.hq = hq;
  a.wq = wq;
  a.c = c;
  a.radius = radius;
  a.feat = fused ? feat : 0;
  return pallas_corr_launch(a, dtype, fused != 0,
                            static_cast<cudaStream_t>(stream));
}

// The box limit of pallas_corr_box_limit (positions a tile stages at once;
// 0 for arguments the kernel does not take).
int dexiraft_pallas_box_limit(int dtype, int fused, int radius, int c,
                              int feat) {
  if (dtype < PALLAS_FP32 || dtype > PALLAS_INT8 || radius < 0 || radius > 8 ||
      c < 16 || c % 16 != 0 || (fused && feat < 1)) {
    return 0;
  }
  return pallas_corr_box_limit(dtype, fused != 0, radius, c, fused ? feat : 0);
}

const char* dexiraft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
