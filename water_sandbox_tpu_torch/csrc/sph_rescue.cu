// Exact capacity-overflow rescue, gated on the device: R1 (density half)
// and R2 (force half).
//
// Replaces water_sandbox_tpu/ops/rescue.py::density_rescue (:61) and
// force_rescue (:116), which the JAX step runs under two nested lax.conds
// on the device (ops/pallas/sph_bucket.py:1701, :1727): XLA ops, not a
// Pallas kernel. Here a kernel is what lets the gate stay on the device.
// Each launch reads the rescued count from device memory; with count 0
// every block returns at once and nothing is written, so a step without
// overflow pays two empty launches and no host read. The selection (the
// cumsum ranks, the fixed (cap,) list of rescued rows, the count) is made
// by ops/rescue.py::rescue_selection before the launches.
//
// Contract (ops/rescue.py::density_rescue_count, force_rescue_count):
//   slot[j] < 0: j is resident (in the bucket planes);
//   0 <= slot[j] < count: j is rescued, sel[slot[j]] == j;
//   slot[j] >= count: j is dropped beyond the budget, out of the physics.
// R1 (in place on den, nden and the six density planes):
//   (a) blocks [0, blocks_a): slot o = blockIdx.x, + blocks_a, ... < count
//       sums w and wn over all n particles, self included, and writes
//       den[sel[o]] = sum + DENSITY_PADDING (nden likewise);
//   (b) the other blocks, one thread a row j: a resident adds the rescued
//       rows' contributions (positions staged through shared memory a tile
//       at a time) and writes its six derived rows (den, nden, EOS
//       half-pressures, reciprocals) into the planes at addr[j], as
//       ops/cuda/sph_bucket.py::derived_density_planes computes them.
//       Dropped-but-unrescued rows keep their fill values.
// R2 (in place on acc): the same two loops for the pair forces of every
// pair that touches a rescued row: (a) a rescued row's whole acceleration
// over all j (self and beyond-budget rows excluded, +y at d == 0), (b) a
// resident's correction from the rescued rows, divided by its own den.
//
// No float atomics: every sum runs in a fixed order (a thread's strided
// loop, then a fixed shuffle-and-shared-memory tree in (a); the rescued
// list in order in (b)), so two launches on the same inputs give the same
// bits. Built with nvcc's default -fmad=true: products and sums contract
// into FMAs, one more reason besides the summation order why the plain
// version agrees to a tolerance (RTOL in chip_smoke.py), not to the bit.
//
// What bounds it on the H100: operations. The sweep tests count x n pairs
// twice (once a side) and keeps the few within h; at the [rescue] phase's
// ~5k rescued rows of 65,536 that is ~0.7 G pair tests, against bytes of a
// few MB. (a) re-reads the positions once per rescued row from L2 and
// reads the other fields of a j only when it lies within h; (b) reads the
// rescued rows' fields once per block from shared memory. A cell-list
// walk for the rescued rows would cut the pair tests by ~n / 30 and is
// left for a later PR.

#include "sph_common.cuh"

namespace wst {

constexpr int kWarps = kBlock / 32;

// Sums V floats over the block in a fixed order; thread 0 gets the totals.
template <int V>
__device__ __forceinline__ void block_sum(float (&v)[V], float* red) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], s);
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[k * kWarps + w];
      v[k] = s;
    }
  }
  __syncthreads();  // red is reused by the next slot
}

template <int DIM>
__device__ __forceinline__ float dist2(const float* a, const float* b) {
  float d2 = 0.f;
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    const float d = a[k] - b[k];
    d2 += d * d;
  }
  return d2;
}

template <int DIM>
__global__ void __launch_bounds__(kBlock)
rescue_density_kernel(const float* __restrict__ pred, int n,
                      const int* __restrict__ sel,
                      const int* __restrict__ slot,
                      const int* __restrict__ count_ptr,
                      const int* __restrict__ addr,
                      const float* __restrict__ prm, float* __restrict__ den,
                      float* __restrict__ nden, float* __restrict__ dens,
                      long long PL, int blocks_a) {
  const int count = *count_ptr;
  if (count <= 0) return;  // the gate: nothing to rescue this step
  const float h = prm[P_H];
  const float pow2 = prm[P_POW2];
  const float pow3 = prm[P_POW3];

  if (static_cast<int>(blockIdx.x) < blocks_a) {
    // (a) a rescued row's exact sums over every particle, self included
    __shared__ float red[2 * kWarps];
    for (int o = blockIdx.x; o < count; o += blocks_a) {
      const int i = sel[o];
      float q[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) q[k] = pred[i * DIM + k];
      float v[2] = {0.f, 0.f};
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        float p[DIM];
#pragma unroll
        for (int k = 0; k < DIM; ++k) p[k] = pred[j * DIM + k];
        const float d = sqrtf(dist2<DIM>(p, q));
        if (d <= h) {
          const float u = h - d;
          const float u2 = u * u;
          v[0] += u2 * pow2;
          v[1] += u2 * u * pow3;
        }
      }
      block_sum<2>(v, red);
      if (threadIdx.x == 0) {
        den[i] = v[0] + kDensityPadding;
        nden[i] = v[1] + kDensityPadding;
      }
    }
    return;
  }

  // (b) a resident's gain from the rescued rows, then its six plane rows
  __shared__ float sp[DIM][kBlock];
  const int j = (blockIdx.x - blocks_a) * blockDim.x + threadIdx.x;
  const bool live = j < n && slot[j] < 0;
  float q[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) q[k] = live ? pred[j * DIM + k] : 0.f;
  float w = 0.f, wn = 0.f;
  for (int base = 0; base < count; base += kBlock) {
    const int m = min(kBlock, count - base);
    if (static_cast<int>(threadIdx.x) < m) {
      const int i = sel[base + threadIdx.x];
#pragma unroll
      for (int k = 0; k < DIM; ++k) sp[k][threadIdx.x] = pred[i * DIM + k];
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < m; ++t) {
        float p[DIM];
#pragma unroll
        for (int k = 0; k < DIM; ++k) p[k] = sp[k][t];
        const float d = sqrtf(dist2<DIM>(p, q));
        if (d <= h) {
          const float u = h - d;
          const float u2 = u * u;
          w += u2 * pow2;
          wn += u2 * u * pow3;
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  const float dj = den[j] + w;
  const float nj = nden[j] + wn;
  den[j] = dj;
  nden[j] = nj;
  const float kp = prm[P_PRESSURE];
  const float pa = kp * 0.5f;
  const float pb = -kp * prm[P_TARGET_DENSITY] * 0.5f;
  const float npa = prm[P_NEAR_PRESSURE] * 0.5f;
  const long long a = addr[j];
  dens[a] = dj;
  dens[PL + a] = nj;
  dens[2 * PL + a] = pa * dj + pb;
  dens[3 * PL + a] = npa * nj;
  dens[4 * PL + a] = 1.f / dj;
  dens[5 * PL + a] = 1.f / nj;
}

// The pair terms shared by both sides: given d (<= h), the common
// derivative factors of the two kernels and the viscosity weight.
struct PairTerms {
  float dw, dwn, wv;
};

__device__ __forceinline__ PairTerms pair_terms(float d, float h,
                                                float pow2_der,
                                                float pow3_der,
                                                float spikey) {
  const float e = d - h;
  const float hv = h * h - d * d;
  return {e * pow2_der, e * e * pow3_der, hv * hv * hv * spikey};
}

template <int DIM>
__global__ void __launch_bounds__(kBlock)
rescue_force_kernel(const float* __restrict__ pred,
                    const float* __restrict__ vel,
                    const float* __restrict__ den,
                    const float* __restrict__ nden,
                    const float* __restrict__ prs,
                    const float* __restrict__ nprs, int n,
                    const int* __restrict__ sel,
                    const int* __restrict__ slot,
                    const int* __restrict__ count_ptr,
                    const float* __restrict__ prm, float* __restrict__ acc,
                    int blocks_a) {
  const int count = *count_ptr;
  if (count <= 0) return;
  const float h = prm[P_H];
  const float pow2_der = prm[P_POW2_DER];
  const float pow3_der = prm[P_POW3_DER];
  const float spikey = prm[P_SPIKEY];
  const float visc = prm[P_VISCOSITY];

  if (static_cast<int>(blockIdx.x) < blocks_a) {
    // (a) a rescued row's whole acceleration, over every particle j
    __shared__ float red[2 * DIM * kWarps];
    for (int o = blockIdx.x; o < count; o += blocks_a) {
      const int i = sel[o];
      float qp[DIM], qv[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        qp[k] = pred[i * DIM + k];
        qv[k] = vel[i * DIM + k];
      }
      const float qprs = prs[i];
      const float qnprs = nprs[i];
      float f[2 * DIM];  // pressure force, then viscosity sum
#pragma unroll
      for (int k = 0; k < 2 * DIM; ++k) f[k] = 0.f;
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        float disp[DIM];  // o -> j
#pragma unroll
        for (int k = 0; k < DIM; ++k) disp[k] = pred[j * DIM + k] - qp[k];
        float d2 = 0.f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) d2 += disp[k] * disp[k];
        const float d = sqrtf(d2);
        if (d > h || j == i || slot[j] >= count) continue;
        const PairTerms t = pair_terms(d, h, pow2_der, pow3_der, spikey);
        const float sh_p = (qprs + prs[j]) * 0.5f;
        const float sh_np = (qnprs + nprs[j]) * 0.5f;
        const float scale = sh_p * t.dw / den[j] + sh_np * t.dwn / nden[j];
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          const float dir = d > 0.f ? disp[k] / d : (k == 1 ? 1.f : 0.f);
          f[k] += dir * scale;
          f[DIM + k] += (vel[j * DIM + k] - qv[k]) * t.wv;
        }
      }
      block_sum<2 * DIM>(f, red);
      if (threadIdx.x == 0) {
        const float di = den[i];
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          acc[i * DIM + k] = f[k] / di + visc * f[DIM + k];
        }
      }
    }
    return;
  }

  // (b) a resident's correction from the rescued rows
  constexpr int F = 2 * DIM + 4;  // pos, vel, den, nden, prs, nprs
  __shared__ float so[F][kBlock];
  const int j = (blockIdx.x - blocks_a) * blockDim.x + threadIdx.x;
  const bool live = j < n && slot[j] < 0;
  float qp[DIM], qv[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    qp[k] = live ? pred[j * DIM + k] : 0.f;
    qv[k] = live ? vel[j * DIM + k] : 0.f;
  }
  const float qprs = live ? prs[j] : 0.f;
  const float qnprs = live ? nprs[j] : 0.f;
  float f[2 * DIM];
#pragma unroll
  for (int k = 0; k < 2 * DIM; ++k) f[k] = 0.f;
  for (int base = 0; base < count; base += kBlock) {
    const int m = min(kBlock, count - base);
    if (static_cast<int>(threadIdx.x) < m) {
      const int i = sel[base + threadIdx.x];
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        so[k][threadIdx.x] = pred[i * DIM + k];
        so[DIM + k][threadIdx.x] = vel[i * DIM + k];
      }
      so[2 * DIM][threadIdx.x] = den[i];
      so[2 * DIM + 1][threadIdx.x] = nden[i];
      so[2 * DIM + 2][threadIdx.x] = prs[i];
      so[2 * DIM + 3][threadIdx.x] = nprs[i];
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < m; ++t) {
        float disp[DIM];  // o -> j
#pragma unroll
        for (int k = 0; k < DIM; ++k) disp[k] = qp[k] - so[k][t];
        float d2 = 0.f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) d2 += disp[k] * disp[k];
        const float d = sqrtf(d2);
        if (d > h) continue;
        const PairTerms pt = pair_terms(d, h, pow2_der, pow3_der, spikey);
        const float sh_p = (so[2 * DIM + 2][t] + qprs) * 0.5f;
        const float sh_np = (so[2 * DIM + 3][t] + qnprs) * 0.5f;
        const float scale = sh_p * pt.dw / so[2 * DIM][t]
                            + sh_np * pt.dwn / so[2 * DIM + 1][t];
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          // j's view: the direction flips, except the +y fallback at d == 0
          const float dir = d > 0.f ? -(disp[k] / d) : (k == 1 ? 1.f : 0.f);
          f[k] += dir * scale;
          f[DIM + k] += (so[DIM + k][t] - qv[k]) * pt.wv;
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  const float dj = den[j];
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    acc[j * DIM + k] += f[k] / dj + visc * f[DIM + k];
  }
}

}  // namespace wst

namespace {

int rows_grid(int n, int blocks_a) {
  return blocks_a + (n + wst::kBlock - 1) / wst::kBlock;
}

}  // namespace

// pred: (n, dim) f32 rows; sel: (cap,) i32; slot: (n,) i32; count: () i32
// on the device; addr: (n,) i32 plane addresses; prm: (16,) f32; den, nden:
// (n,) f32 and dens: (6, cap_p, L) f32, all three updated in place;
// blocks_a: blocks of part (a). Launches on `stream` of `device` and
// returns cudaGetLastError().
extern "C" int wst_sph_rescue_density(const float* pred, int n,
                                      const int* sel, const int* slot,
                                      const int* count, const int* addr,
                                      const float* prm, float* den,
                                      float* nden, float* dens, int dim,
                                      int cap_p, int L, int blocks_a,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || blocks_a <= 0) return static_cast<int>(cudaGetLastError());
  const long long PL = static_cast<long long>(cap_p) * L;
  const dim3 grid(static_cast<unsigned>(rows_grid(n, blocks_a)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    wst::rescue_density_kernel<3><<<grid, wst::kBlock, 0, s>>>(
        pred, n, sel, slot, count, addr, prm, den, nden, dens, PL, blocks_a);
  } else if (dim == 2) {
    wst::rescue_density_kernel<2><<<grid, wst::kBlock, 0, s>>>(
        pred, n, sel, slot, count, addr, prm, den, nden, dens, PL, blocks_a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// pred, vel: (n, dim) f32; den, nden, prs, nprs: (n,) f32; sel, slot,
// count as above; prm: (16,) f32; acc: (n, dim) f32 updated in place.
extern "C" int wst_sph_rescue_force(const float* pred, const float* vel,
                                    const float* den, const float* nden,
                                    const float* prs, const float* nprs,
                                    int n, const int* sel, const int* slot,
                                    const int* count, const float* prm,
                                    float* acc, int dim, int blocks_a,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || blocks_a <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>(rows_grid(n, blocks_a)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    wst::rescue_force_kernel<3><<<grid, wst::kBlock, 0, s>>>(
        pred, vel, den, nden, prs, nprs, n, sel, slot, count, prm, acc,
        blocks_a);
  } else if (dim == 2) {
    wst::rescue_force_kernel<2><<<grid, wst::kBlock, 0, s>>>(
        pred, vel, den, nden, prs, nprs, n, sel, slot, count, prm, acc,
        blocks_a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
