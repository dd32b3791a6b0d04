// SPH density pass over the slot-major bucket planes.
//
// Replaces the TPU kernel water_sandbox_tpu/ops/pallas/sph_bucket.py::
// _density_kernel (launched by _run_density, production gate ("slab", 8)).
// Same output contract: for every occupied slot, over the 3^DIM neighbour
// cells (self included)
//   den  = sum max(h - d, 0)^2 * pow2 + DENSITY_PADDING
//   nden = sum max(h - d, 0)^3 * pow3 + DENSITY_PADDING
// and six planes: den, nden, k/2*den - k/2*rho0, k_near/2*nden, 1/den,
// 1/nden. Outputs at empty slots are left unwritten (nothing reads them).
//
// Design. One thread per particle row r: addr[r] is the row's plane address
// (slot * L + lane), or the capacity-overflow sentinel cap_p * L, which is
// skipped. The thread walks the 3^DIM neighbour lanes and, in each, only the
// occupied slots c < counts[lane'] (slots fill from 0), so it visits exactly
// the pairs the TPU kernel's occupancy gates admit. Row-wrap aliases of the
// flat lane axis are spatially far and fail the distance test, as on the TPU.
//
// What bounds it on the H100: not arithmetic (~10 flops a pair) but the
// dependent, scattered loads — counts, then candidate positions — spread
// over dim planes of cap_p * L floats (36 MB at reference-cube, inside the
// 50 MB L2). Rows arrive in cell-sorted order on the main path, so a warp's
// threads mostly share or neighbour cells and their candidate loads coalesce
// or broadcast. Not done yet: staging a slab's halo window in shared memory
// (the TPU's _window_dma), TMA, and more than one thread per query.
//
// Built without --use_fast_math: sqrtf and the divisions stay IEEE.

#include "sph_common.cuh"

namespace wst {

template <int DIM>
__global__ void __launch_bounds__(kBlock)
sph_density_kernel(const float* __restrict__ planes,
                   const float* __restrict__ counts,
                   const int* __restrict__ addr, int n,
                   const float* __restrict__ prm, float* __restrict__ out,
                   Geom g) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long PL = g.plane();
  const int a = addr[r];
  if (a >= PL) return;  // capacity-overflow sentinel
  const int lane = a % g.L;

  const float h = prm[P_H];
  const float pow2 = prm[P_POW2];
  const float pow3 = prm[P_POW3];

  float q[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) q[k] = planes[k * PL + a];

  float den = 0.f, nden = 0.f;
  constexpr int OZ = DIM == 3 ? 1 : 0;
  for (int ox = -1; ox <= 1; ++ox) {
    for (int oy = -1; oy <= 1; ++oy) {
      for (int oz = -OZ; oz <= OZ; ++oz) {
        const int nl = lane + ox * g.S_pad + oy * g.gz + oz;
        const int cnt = static_cast<int>(counts[nl]);
        for (int c = 0; c < cnt; ++c) {
          const long long ca = static_cast<long long>(c) * g.L + nl;
          float d2 = 0.f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            const float d = planes[k * PL + ca] - q[k];
            d2 += d * d;
          }
          const float v = fmaxf(h - sqrtf(d2), 0.f);
          const float v2 = v * v;
          den += v2 * pow2;
          nden += v2 * v * pow3;
        }
      }
    }
  }
  den += kDensityPadding;
  nden += kDensityPadding;

  const float k = prm[P_PRESSURE];
  const float pa = k * 0.5f;
  const float pb = -k * prm[P_TARGET_DENSITY] * 0.5f;
  const float npa = prm[P_NEAR_PRESSURE] * 0.5f;
  out[a] = den;
  out[PL + a] = nden;
  out[2 * PL + a] = pa * den + pb;
  out[3 * PL + a] = npa * nden;
  out[4 * PL + a] = 1.f / den;
  out[5 * PL + a] = 1.f / nden;
}

}  // namespace wst

// planes: (>= dim, cap_p, L) f32; counts: (L,) f32 occupied slots per lane;
// addr: (n,) i32 plane addresses; prm: (16,) f32; out: (6, cap_p, L) f32.
// Launches on `stream` of `device` and returns cudaGetLastError().
extern "C" int wst_sph_density(const float* planes, const float* counts,
                               const int* addr, int n, const float* prm,
                               float* out, int dim, int cap_p, int L,
                               int S_pad, int gz, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const wst::Geom g{cap_p, L, S_pad, gz};
  const dim3 grid((n + wst::kBlock - 1) / wst::kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    wst::sph_density_kernel<3><<<grid, wst::kBlock, 0, s>>>(
        planes, counts, addr, n, prm, out, g);
  } else if (dim == 2) {
    wst::sph_density_kernel<2><<<grid, wst::kBlock, 0, s>>>(
        planes, counts, addr, n, prm, out, g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
