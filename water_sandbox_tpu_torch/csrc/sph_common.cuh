// Shared definitions of the bucket-grid SPH kernels (sph_density.cu,
// sph_force.cu). They must match water_sandbox_tpu_torch/ops/cuda/sph_bucket.py:
// the parameter-vector slots (_P_*) and DENSITY_PADDING.
#pragma once

#include <cuda_runtime.h>

namespace wst {

// Slots of the (1, 16) float32 parameter vector (_param_vector).
constexpr int P_H = 0;
constexpr int P_POW2 = 1;
constexpr int P_POW2_DER = 2;
constexpr int P_POW3 = 3;
constexpr int P_POW3_DER = 4;
constexpr int P_SPIKEY = 5;
constexpr int P_PRESSURE = 6;
constexpr int P_NEAR_PRESSURE = 7;
constexpr int P_TARGET_DENSITY = 8;
constexpr int P_VISCOSITY = 9;

constexpr float kDensityPadding = 1e-5f;
constexpr int kBlock = 256;

// Plane geometry of the slot-major bucket layout: plane p, slot c, lane l
// lives at p * cap_p * L + c * L + l. A neighbour cell at offset
// (ox, oy, oz) is lane l + ox * S_pad + oy * gz + oz (gz == 1 and oz == 0
// in 2-D).
struct Geom {
  int cap_p;
  int L;
  int S_pad;
  int gz;
  __host__ __device__ long long plane() const {
    return static_cast<long long>(cap_p) * L;
  }
};

}  // namespace wst
