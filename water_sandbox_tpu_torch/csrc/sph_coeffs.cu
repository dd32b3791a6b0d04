// The step's kernel parameters in two one-block launches: the five
// smoothing-kernel coefficients from the radius (core/params.py::
// KernelCoeffs.from_radius), and the (1, 16) parameter vector that K1, K2,
// R1, R2, D1 and D2 read (ops/cuda/sph_bucket.py::_param_vector).
//
// Replaces no TPU kernel: the JAX package leaves both to XLA, which fuses
// them into the step. They take the place of the port's ATen chains for the
// same values, some 31 and 3 one-element launches, and must equal them bit
// for bit.
//
// What bounds them on the H100: the launch. Each reads at most ten floats
// and writes at most sixteen; the chains they replace cost a launch and the
// gap to the next graph node for every multiply, division and fill.
//
// Design.
// * One thread a value. The radius and the parameters are read through
//   device pointers to the SimParams leaves and the coefficients, so a
//   captured graph sees what Simulation.tune copies into them, and the
//   coefficients golden.flipped_near_derivative hands over.
// * The same bits as the chain. h^p is _ipow's square-and-multiply in its
//   order, num / (den_scale * h^p) one rounded product and an IEEE division
//   (__fmul_rn, __fdiv_rn: no FMA contraction, no reciprocal). The host
//   passes each coefficient's numerator, denominator scale (rounded to f32,
//   as ATen rounds a Python float against an f32 tensor) and power, from
//   the table the chain reads (core/params.py::_COEFF_TERMS).

#include "sph_common.cuh"

namespace wst {

constexpr int kCoeffs = 5;

// num / (den * h^pow) of each coefficient, in KernelCoeffs' field order.
struct CoeffTerms {
  float num[kCoeffs];
  float den[kCoeffs];
  int pow[kCoeffs];
};

// x^y by square-and-multiply in the order of core/params.py::_ipow (y > 0).
__device__ __forceinline__ float ipow(float x, int y) {
  float acc = 0.0f;
  bool have = false;
  while (y > 0) {
    if (y & 1) {
      acc = have ? __fmul_rn(acc, x) : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = __fmul_rn(x, x);
  }
  return acc;
}

__global__ void sph_coeffs_kernel(const float* __restrict__ h,
                                  CoeffTerms t, float* __restrict__ out) {
  const int k = threadIdx.x;
  if (k >= kCoeffs) return;
  const float hp = ipow(*h, t.pow[k]);
  out[k] = __fdiv_rn(t.num[k], __fmul_rn(t.den[k], hp));
}

// The scalars of the parameter vector, one device pointer a slot, slot P_H
// first (host order: ops/cuda/sph_bucket.py::_param_values).
constexpr int kParamValues = 10;
constexpr int kParamSlots = 16;
static_assert(P_H == 0 && P_POW2 == 1 && P_POW2_DER == 2 && P_POW3 == 3 &&
                  P_POW3_DER == 4 && P_SPIKEY == 5 && P_PRESSURE == 6 &&
                  P_NEAR_PRESSURE == 7 && P_TARGET_DENSITY == 8 &&
                  P_VISCOSITY == kParamValues - 1,
              "the parameter vector's slots are its sources' order");
struct ParamSources {
  const float* p[kParamValues];
};

__global__ void sph_param_vector_kernel(ParamSources s,
                                        float* __restrict__ out) {
  const int k = threadIdx.x;
  if (k < kParamSlots) out[k] = k < kParamValues ? *s.p[k] : 0.0f;
}

}  // namespace wst

// h: a () f32 device tensor; num, den: host arrays of 5 floats, pow: of 5
// ints (the coefficients' terms); out: 5 f32, contiguous. Launches on
// `stream` of `device` and returns cudaGetLastError().
extern "C" int wst_sph_coeffs(const float* h, const float* num,
                              const float* den, const int* pow, float* out,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  wst::CoeffTerms t;
  for (int k = 0; k < wst::kCoeffs; ++k) {
    if (pow[k] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    t.num[k] = num[k];
    t.den[k] = den[k];
    t.pow[k] = pow[k];
  }
  wst::sph_coeffs_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      h, t, out);
  return static_cast<int>(cudaGetLastError());
}

// sources: a host array of the 10 device pointers of ParamSources, in its
// order; out: 16 f32, contiguous. Launches on `stream` of `device` and
// returns cudaGetLastError().
extern "C" int wst_sph_param_vector(const float* const* sources, float* out,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  wst::ParamSources s;
  for (int k = 0; k < wst::kParamValues; ++k) s.p[k] = sources[k];
  wst::sph_param_vector_kernel<<<1, 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(s, out);
  return static_cast<int>(cudaGetLastError());
}
