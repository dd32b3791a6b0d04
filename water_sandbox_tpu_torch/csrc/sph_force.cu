// SPH force pass (pressure + near pressure + viscosity) over the slot-major
// bucket planes.
//
// Replaces the TPU kernel water_sandbox_tpu/ops/pallas/sph_bucket.py::
// _force_sym_kernel (launched by _run_force, production gate ("qsym", 8)),
// and computes the output contract of its query-side sibling _force_kernel
// (gate ("qrow3", 8)): for every occupied slot i, over the neighbours j
// within h of the 3^DIM neighbour cells, self pair excluded,
//   acc_i = sum_j  d_ij/|d_ij| * (1/rho_i) * [ (P_i + P_j)/2 * dW2 / rho_j
//                                             + (Pn_i + Pn_j)/2 * dW3 / nrho_j ]
//         + mu * spikey * sum_j (v_j - v_i) (h^2 - |d|^2)^3
// with the +y direction when d == 0. The half-pressures and reciprocals come
// from the density pass's planes 2-5; den/nden pass through to planes 0-1 so
// one gather returns every per-particle result. Output (2 + DIM planes) at
// empty slots is left unwritten.
//
// The domain-decomposed step (parallel/domain.py) launches it where the JAX
// package pins _force_kernel itself: the queries are a shard's local rows,
// and the neighbours' boundary slabs, copied into the lanes just inside the
// pads, are read as candidates only (through `counts`). A pair-once kernel
// would write the mirrored halves of boundary pairs into those halo lanes,
// which no shard reads back.
//
// Design. One thread per particle row, as in sph_density.cu: the thread
// walks the occupied slots of its 3^DIM neighbour lanes and evaluates every
// pair from the query side, so it writes only its own slot and needs no
// state shared across blocks. The TPU's qsym scheme evaluates each pair once
// and applies it to both sides, carrying the mirrored halves in VMEM from one
// grid step to the next; that relies on grid steps running in order, which
// CUDA blocks do not. Doing the same here needs float atomics or per-block
// spill buffers and a fold, which is later work.
//
// What bounds it on the H100: dependent scattered loads again — per
// candidate 2*DIM feature floats and 4 density-pass floats over planes of
// cap_p * L floats (about 120 MB at reference-cube, more than the 50 MB L2),
// plus ~40 flops. Cell-sorted row order keeps a warp's candidate loads
// mostly coalesced or broadcast. Not done yet: shared-memory halo windows,
// TMA, and the pair-once scheme.
//
// Built without --use_fast_math; rsqrtf is the one approximate operation
// (<= 2 ulp), as jax.lax.rsqrt is on the TPU.

#include "sph_common.cuh"

namespace wst {

template <int DIM>
__global__ void __launch_bounds__(kBlock)
sph_force_kernel(const float* __restrict__ planes,
                 const float* __restrict__ dens,
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
  const int qslot = a / g.L;

  const float h = prm[P_H];
  const float h2 = h * h;
  const float pow2_der = prm[P_POW2_DER];
  const float pow3_der = prm[P_POW3_DER];
  const float spikey_visc = prm[P_SPIKEY] * prm[P_VISCOSITY];

  float q[DIM], qv[DIM], f[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    q[k] = planes[k * PL + a];
    qv[k] = planes[(DIM + k) * PL + a];
    f[k] = 0.f;
  }
  const float qprs = dens[2 * PL + a];
  const float qnprs = dens[3 * PL + a];
  const float qden_inv = dens[4 * PL + a];

  constexpr int OZ = DIM == 3 ? 1 : 0;
  for (int ox = -1; ox <= 1; ++ox) {
    for (int oy = -1; oy <= 1; ++oy) {
      for (int oz = -OZ; oz <= OZ; ++oz) {
        const int nl = lane + ox * g.S_pad + oy * g.gz + oz;
        const int cnt = static_cast<int>(counts[nl]);
        for (int c = 0; c < cnt; ++c) {
          if (nl == lane && c == qslot) continue;  // self pair
          const long long ca = static_cast<long long>(c) * g.L + nl;
          float d[DIM];
#pragma unroll
          for (int k = 0; k < DIM; ++k) d[k] = planes[k * PL + ca] - q[k];
          float dist2 = d[0] * d[0];
#pragma unroll
          for (int k = 1; k < DIM; ++k) dist2 += d[k] * d[k];
          if (!(dist2 <= h2)) continue;

          const float inv = rsqrtf(fmaxf(dist2, 1e-30f));
          const float v = dist2 * inv - h;
          const float shared_p = qprs + dens[2 * PL + ca];
          const float shared_np = qnprs + dens[3 * PL + ca];
          const float scale =
              qden_inv * (shared_p * (v * pow2_der) * dens[4 * PL + ca] +
                          shared_np * ((v * v) * pow3_der) * dens[5 * PL + ca]);
          const float scale_i = scale * inv;
          const float hv = h2 - dist2;
          const float w_visc = (hv * hv * hv) * spikey_visc;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            f[k] += d[k] * scale_i +
                    (planes[(DIM + k) * PL + ca] - qv[k]) * w_visc;
          }
          if (dist2 == 0.f) f[1] += scale;  // +y fallback at d == 0
        }
      }
    }
  }

  out[a] = dens[a];
  out[PL + a] = dens[PL + a];
#pragma unroll
  for (int k = 0; k < DIM; ++k) out[(2 + k) * PL + a] = f[k];
}

}  // namespace wst

// planes: (>= 2*dim, cap_p, L) f32 positions then velocities; dens: the
// density pass's (6, cap_p, L) f32; counts: (L,) f32; addr: (n,) i32;
// prm: (16,) f32; out: (2 + dim, cap_p, L) f32. Launches on `stream` of
// `device` and returns cudaGetLastError().
extern "C" int wst_sph_force(const float* planes, const float* dens,
                             const float* counts, const int* addr, int n,
                             const float* prm, float* out, int dim, int cap_p,
                             int L, int S_pad, int gz, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const wst::Geom g{cap_p, L, S_pad, gz};
  const dim3 grid((n + wst::kBlock - 1) / wst::kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    wst::sph_force_kernel<3><<<grid, wst::kBlock, 0, s>>>(
        planes, dens, counts, addr, n, prm, out, g);
  } else if (dim == 2) {
    wst::sph_force_kernel<2><<<grid, wst::kBlock, 0, s>>>(
        planes, dens, counts, addr, n, prm, out, g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
