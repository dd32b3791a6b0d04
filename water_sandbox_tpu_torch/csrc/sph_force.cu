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
// package pins _force_kernel itself: the queries are a shard's local rows
// (`addr`), and the neighbours' boundary slabs, copied into the lanes just
// inside the pads, are read as candidates only (through `counts`). A
// pair-once kernel would write the mirrored halves of boundary pairs into
// those halo lanes, which no shard reads back.
//
// Design. G threads per particle row (G = 1, 2 or 4, a group of consecutive
// lanes of one warp): the rows of `addr` come in cell-sorted order, so a
// warp's queries sit in neighbouring lanes and their candidate loads are
// mostly coalesced or broadcast. Every pair is evaluated from the query side
// and only thread 0 of a group writes, its row's own slot, so no state is
// shared across blocks. With G = 1 the thread walks the occupied slots of all
// 3^DIM neighbour cells; with G > 1 thread t takes cells t, t + G, ... and
// the group sums its partial accelerations with __shfl_xor_sync. The launcher
// picks G from the row count (sph_bucket.py::_row_group): with few rows one
// thread a row leaves most of the SMs' warp slots empty, and each thread's
// chain of dependent loads (counts, then a candidate's position, then its 7
// other floats) is long; a group splits the chain and fills the slots. With
// rows enough to fill the card the shuffles and the group's idle lanes cost
// more than they hide, so G = 1.
//
// No shared-memory halo windows, unlike the TPU kernel's VMEM windows:
// staging each 64-lane tile's window of positions (cp.async, a few threads a
// query) timed slower than one thread a row on the H100 at every main-path
// state, because a tile's work follows its occupancy, so blocks of one size
// idle, and every tile pays its count reads and staging first. The TPU's qsym
// scheme evaluates each pair once and applies it to both sides, carrying the
// mirrored halves in VMEM from one grid step to the next; that relies on grid
// steps running in order, which CUDA blocks do not, and needs float atomics
// or per-block spill buffers and a fold here.
//
// Built without --use_fast_math; rsqrtf is the one approximate operation
// (<= 2 ulp), as jax.lax.rsqrt is on the TPU.

#include "sph_common.cuh"

namespace wst {

// The query's terms: what one thread needs to add a candidate's pair.
template <int DIM>
struct Query {
  float q[DIM], qv[DIM];
  float prs, nprs, den_inv;
  float h, h2, pow2_der, pow3_der, spikey_visc;
};

// Adds the pair (query, candidate at plane offset ca) to f if it lies
// within h.
template <int DIM>
__device__ __forceinline__ void add_pair(const Query<DIM>& Q,
                                         const float* __restrict__ planes,
                                         const float* __restrict__ dens,
                                         long long PL, long long ca,
                                         float* f) {
  float d[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) d[k] = planes[k * PL + ca] - Q.q[k];
  float dist2 = d[0] * d[0];
#pragma unroll
  for (int k = 1; k < DIM; ++k) dist2 += d[k] * d[k];
  if (!(dist2 <= Q.h2)) return;

  const float inv = rsqrtf(fmaxf(dist2, 1e-30f));
  const float v = dist2 * inv - Q.h;
  const float shared_p = Q.prs + dens[2 * PL + ca];
  const float shared_np = Q.nprs + dens[3 * PL + ca];
  const float scale =
      Q.den_inv * (shared_p * (v * Q.pow2_der) * dens[4 * PL + ca] +
                   shared_np * ((v * v) * Q.pow3_der) * dens[5 * PL + ca]);
  const float scale_i = scale * inv;
  const float hv = Q.h2 - dist2;
  const float w_visc = (hv * hv * hv) * Q.spikey_visc;
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    f[k] += d[k] * scale_i + (planes[(DIM + k) * PL + ca] - Q.qv[k]) * w_visc;
  }
  if (dist2 == 0.f) f[1] += scale;  // +y fallback at d == 0
}

template <int DIM, int G>
__global__ void __launch_bounds__(kBlock)
sph_force_kernel(const float* __restrict__ planes,
                 const float* __restrict__ dens,
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

  float f[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) f[k] = 0.f;

  if (live) {
    const int lane = a % g.L;
    const int qslot = a / g.L;
    Query<DIM> Q;
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      Q.q[k] = planes[k * PL + a];
      Q.qv[k] = planes[(DIM + k) * PL + a];
    }
    Q.prs = dens[2 * PL + a];
    Q.nprs = dens[3 * PL + a];
    Q.den_inv = dens[4 * PL + a];
    Q.h = prm[P_H];
    Q.h2 = Q.h * Q.h;
    Q.pow2_der = prm[P_POW2_DER];
    Q.pow3_der = prm[P_POW3_DER];
    Q.spikey_visc = prm[P_SPIKEY] * prm[P_VISCOSITY];

    constexpr int OZ = DIM == 3 ? 1 : 0;
    if (G == 1) {
      // one thread walks all 3^DIM cells; the z run of three cells in the
      // innermost loop (timed faster than one flat loop over the cells)
      for (int ox = -1; ox <= 1; ++ox) {
        for (int oy = -1; oy <= 1; ++oy) {
          for (int oz = -OZ; oz <= OZ; ++oz) {
            const int nl = lane + ox * g.S_pad + oy * g.gz + oz;
            const int cnt = static_cast<int>(counts[nl]);
            for (int c = 0; c < cnt; ++c) {
              if (nl == lane && c == qslot) continue;  // self pair
              add_pair(Q, planes, dens, PL,
                       static_cast<long long>(c) * g.L + nl, f);
            }
          }
        }
      }
    } else {
      // thread t takes cells t, t + G, ... of the 3^DIM, z fastest
      constexpr int W = 2 * OZ + 1;
      for (int j = t; j < 9 * W; j += G) {
        const int nl = lane + (j / (3 * W) - 1) * g.S_pad +
                       ((j / W) % 3 - 1) * g.gz + (j % W - OZ);
        const int cnt = static_cast<int>(counts[nl]);
        for (int c = 0; c < cnt; ++c) {
          if (nl == lane && c == qslot) continue;  // self pair
          add_pair(Q, planes, dens, PL, static_cast<long long>(c) * g.L + nl,
                   f);
        }
      }
    }
  }

  if (G > 1) {
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
#pragma unroll
      for (int s = G / 2; s > 0; s >>= 1) {
        f[k] += __shfl_xor_sync(0xffffffffu, f[k], s);
      }
    }
  }
  if (live && t == 0) {
    out[a] = dens[a];
    out[PL + a] = dens[PL + a];
#pragma unroll
    for (int k = 0; k < DIM; ++k) out[(2 + k) * PL + a] = f[k];
  }
}

template <int DIM>
cudaError_t launch_force(int group, const float* planes, const float* dens,
                         const float* counts, const int* addr, int n,
                         const float* prm, float* out, Geom g,
                         cudaStream_t s) {
  const long long threads = static_cast<long long>(n) * group;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  switch (group) {
    case 1:
      sph_force_kernel<DIM, 1><<<grid, kBlock, 0, s>>>(
          planes, dens, counts, addr, n, prm, out, g);
      break;
    case 2:
      sph_force_kernel<DIM, 2><<<grid, kBlock, 0, s>>>(
          planes, dens, counts, addr, n, prm, out, g);
      break;
    case 4:
      sph_force_kernel<DIM, 4><<<grid, kBlock, 0, s>>>(
          planes, dens, counts, addr, n, prm, out, g);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace wst

// planes: (>= 2*dim, cap_p, L) f32 positions then velocities; dens: the
// density pass's (6, cap_p, L) f32; counts: (L,) f32; addr: (n,) i32;
// prm: (16,) f32; out: (2 + dim, cap_p, L) f32; group: threads a row (1, 2 or
// 4). Launches on `stream` of `device` and returns cudaGetLastError().
extern "C" int wst_sph_force(const float* planes, const float* dens,
                             const float* counts, const int* addr, int n,
                             const float* prm, float* out, int dim, int cap_p,
                             int L, int S_pad, int gz, int group, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const wst::Geom g{cap_p, L, S_pad, gz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    err = wst::launch_force<3>(group, planes, dens, counts, addr, n, prm, out,
                               g, s);
  } else if (dim == 2) {
    err = wst::launch_force<2>(group, planes, dens, counts, addr, n, prm, out,
                               g, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
