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
// What bounds it on the H100: neither bytes (a row reads DIM positions and
// its address and writes six floats; the candidates it walks sit in planes
// that fit the 50 MB L2) nor arithmetic (~17 flops a candidate), but
// latency: a row is a chain of dependent loads, a cell's count and then
// that cell's candidates one after another, and with few rows one thread a
// row leaves most of an SM's 64 warp slots empty, so nothing hides the
// chain.
//
// Design.
// * The run of three adjacent lanes as one walk. The 3^DIM neighbour lanes
//   are 3^(DIM-1) runs of three adjacent lanes (the z neighbours in 3-D,
//   the y neighbours in 2-D). A run is walked slot by slot up to the
//   largest of its three counts, and slot c's three candidates are three
//   adjacent floats in each position plane: three independent loads a plane
//   from one 12-byte segment, in place of three separate cell walks. The
//   loads are not predicated on the single counts: an empty slot of a
//   position plane holds _FAR (the build's fill, sph_bucket.py), which
//   fails the distance test below like any far candidate.
// * Leave before the root, in 3-D: only candidates with d^2 < h^2 pay sqrtf
//   and the two polynomials; about five in six of the candidates of the 27
//   cells lie outside the sphere and would add +0. In 2-D a third of the
//   nine cells' candidates lie inside the disc, and the branch timed slower
//   than the straight-line max(h - d, 0) at every 2-D state, so there every
//   candidate is evaluated (_FAR gives max(h - 1e15, 0) = 0).
// * G threads per particle row (G = 1, 2 or 4, consecutive lanes of one
//   warp), as in sph_force.cu: thread t takes runs t, t + G, ... (x
//   outermost), den and nden are joined with __shfl_xor_sync and thread 0
//   writes the row's six planes. The launcher picks G from the row count
//   (sph_bucket.py::_row_group): several threads a row while the rows alone
//   leave the warp slots empty, one once they fill the card, where the
//   shuffles and a group's idle lanes cost more than they hide. addr[r] is
//   the row's plane address (slot * L + lane) or the capacity-overflow
//   sentinel cap_p * L, whose row is skipped; with G > 1 its threads stay
//   for the shuffles.
// * Row-wrap aliases of the flat lane axis are spatially far and fail the
//   distance test, as on the TPU. Rows come in cell-sorted order on the
//   main path, so a warp's rows share or neighbour cells and their loads
//   coalesce or broadcast.
// * No atomics and a fixed order of summation: two launches on the same
//   inputs with the same G give the same bits.
// Timed and left out: loading all of a thread's counts into registers
// before the first walk, predicating each lane of a run on its own count
// (slower than letting _FAR fail the distance test), and in 2-D a walk cell
// by cell to each cell's own count (slower than the run at four threads a
// row, the group every 2-D scene takes, and no faster with one).
//
// Built without --use_fast_math: sqrtf and the divisions stay IEEE.

#include "sph_common.cuh"

namespace wst {

// Adds the candidate at plane offset ca to the row's sums: in 3-D only if
// it lies within h, in 2-D always (a term beyond h is +0).
template <int DIM>
__device__ __forceinline__ void add_candidate(
    const float* __restrict__ planes, long long PL, long long ca,
    const float* q, float h, float h2, float pow2, float pow3, float& den,
    float& nden) {
  float d2 = 0.f;
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    const float d = planes[k * PL + ca] - q[k];
    d2 += d * d;
  }
  if (DIM == 3) {
    if (d2 < h2) {
      const float v = h - sqrtf(d2);
      const float v2 = v * v;
      den += v2 * pow2;
      nden += v2 * v * pow3;
    }
  } else {
    const float v = fmaxf(h - sqrtf(d2), 0.f);
    const float v2 = v * v;
    den += v2 * pow2;
    nden += v2 * v * pow3;
  }
}

template <int DIM, int G>
__global__ void __launch_bounds__(kBlock)
sph_density_kernel(const float* __restrict__ planes,
                   const float* __restrict__ counts,
                   const int* __restrict__ addr, int n,
                   const float* __restrict__ prm, float* __restrict__ out,
                   Geom g) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int r = static_cast<int>(tid / G);
  const int t = static_cast<int>(tid % G);
  const long long PL = g.plane();
  int a = 0;
  bool live = false;  // a real row, not a capacity-overflow sentinel
  if (r < n) {
    a = addr[r];
    live = a < PL;
  }
  if (G == 1 && !live) return;  // with G > 1 every lane joins the shuffles

  float den = 0.f, nden = 0.f;
  if (live) {
    const int lane = a % g.L;
    const float h = prm[P_H];
    const float h2 = h * h;
    const float pow2 = prm[P_POW2];
    const float pow3 = prm[P_POW3];
    float q[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) q[k] = planes[k * PL + a];

    // runs of three adjacent lanes: (ox, oy) with z along the run in 3-D,
    // ox with y along the run in 2-D (gz == 1)
    constexpr int RUNS = DIM == 3 ? 9 : 3;
    for (int rr = t; rr < RUNS; rr += G) {
      const int mid = DIM == 3
          ? lane + (rr / 3 - 1) * g.S_pad + (rr % 3 - 1) * g.gz
          : lane + (rr - 1) * g.S_pad;
      const int cnt = static_cast<int>(
          fmaxf(counts[mid - 1], fmaxf(counts[mid], counts[mid + 1])));
      for (int c = 0; c < cnt; ++c) {
        const long long ca = static_cast<long long>(c) * g.L + mid;
#pragma unroll
        for (int z = -1; z <= 1; ++z) {
          add_candidate<DIM>(planes, PL, ca + z, q, h, h2, pow2, pow3, den,
                             nden);
        }
      }
    }
  }

  if (G > 1) {
#pragma unroll
    for (int s = G / 2; s > 0; s >>= 1) {
      den += __shfl_xor_sync(0xffffffffu, den, s);
      nden += __shfl_xor_sync(0xffffffffu, nden, s);
    }
  }
  if (live && t == 0) {
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
}

template <int DIM>
cudaError_t launch_density(int group, const float* planes,
                           const float* counts, const int* addr, int n,
                           const float* prm, float* out, Geom g,
                           cudaStream_t s) {
  const long long threads = static_cast<long long>(n) * group;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  switch (group) {
    case 1:
      sph_density_kernel<DIM, 1><<<grid, kBlock, 0, s>>>(
          planes, counts, addr, n, prm, out, g);
      break;
    case 2:
      sph_density_kernel<DIM, 2><<<grid, kBlock, 0, s>>>(
          planes, counts, addr, n, prm, out, g);
      break;
    case 4:
      sph_density_kernel<DIM, 4><<<grid, kBlock, 0, s>>>(
          planes, counts, addr, n, prm, out, g);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace wst

// planes: (>= dim, cap_p, L) f32; counts: (L,) f32 occupied slots per lane;
// addr: (n,) i32 plane addresses; prm: (16,) f32; out: (6, cap_p, L) f32;
// group: threads a row (1, 2 or 4). Launches on `stream` of `device` and
// returns cudaGetLastError().
extern "C" int wst_sph_density(const float* planes, const float* counts,
                               const int* addr, int n, const float* prm,
                               float* out, int dim, int cap_p, int L,
                               int S_pad, int gz, int group, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const wst::Geom g{cap_p, L, S_pad, gz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    err = wst::launch_density<3>(group, planes, counts, addr, n, prm, out, g,
                                 s);
  } else if (dim == 2) {
    err = wst::launch_density<2>(group, planes, counts, addr, n, prm, out, g,
                                 s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
