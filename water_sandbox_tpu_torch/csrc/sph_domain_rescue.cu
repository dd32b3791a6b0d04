// Exact capacity-overflow rescue of the domain-decomposed step, across
// shard boundaries, gated on the device: D1 (density half) and D2 (force
// half).
//
// Replaces water_sandbox_tpu/parallel/domain.py::_rescue_density_common
// (:641) and _rescue_force_common (:689), with the packing of _pack_dropped
// (:497), which the JAX domain step runs under lax.cond on
// pmax(overflow) > 0 (:382, :421, :459): XLA ops, not a Pallas kernel. As
// for R1 and R2 (sph_rescue.cu), a kernel is what keeps the gate on the
// device: each launch reads the shard's count of valid query rows from
// device memory and, at 0, every block returns at once and nothing is
// written, so a step without overflow pays two empty launches a shard and
// no host read. The count covers the neighbours' rows too: a shard whose
// neighbour overflows takes that neighbour's rows' corrections.
//
// One launch works on one shard. Its query rows Q (nq = 3R, packed and
// exchanged by parallel/domain.py before the launch): the shard's first R
// dropped rows in row order ("mine", Q[0, R)), the left neighbour's R
// (Q[R, 2R)) and the right one's (Q[2R, 3R)). An invalid row (past a
// shard's dropped count, or sent across the mesh's wrapped edge) has the
// column kNoCol. A resident is an active row with a plane address.
// D1 (in place on the density planes dens; writes qden, qnden):
//   (a) my valid row o sums w and wn over the shard's active rows within h
//       (itself included), the occupied halo slots and the neighbours'
//       valid rows, and writes qden[o] = sum + DENSITY_PADDING (qnden
//       likewise);
//   (b) a resident adds the terms of every valid Q row within h to its den
//       and nden in the planes at addr and rewrites its six derived rows
//       there as K1 (sph_density.cu) writes them. The step launches D1
//       before the density halo exchange, so the neighbours' force kernels
//       read the corrected rows.
// D2 (in place on acc):
//   (a) my valid row o, local row i = qrow[o]: the pair forces over the
//       same candidates, less itself and the rows dropped beyond the budget
//       (slot >= R), the halo slots with their exchanged, corrected
//       densities; acc[i] = pressure sum / qden[o] + viscosity * viscosity
//       sum (+y at d == 0);
//   (b) a resident adds the pair forces of every valid Q row within h,
//       divided by its own den.
//
// The walk is R1's and R2's (sph_walk.cuh), over this shard's sorted rows.
// The shard's build (ops/cuda/sph_bucket.py::build_local_slab_buckets)
// sorts the rows by their clamped local column (x clamped into the slab, y
// and z into the grid; inactive rows take the key gx * S_pad and sort
// last, where no run reaches) and returns skey (ascending) and order (the
// row at each position). A Q row's column is the same clamped key
// (ops/cuda/domain_rescue.py::query_walk).
//   (a) one block a row of mine: groups of 8 lanes find the position
//       ranges of its 3^(DIM-1) runs and the threads take the positions
//       t (mod blockDim); then every slot of the halo lanes of its own y/z
//       window, in the left halo slab when its x is 0 and in the right one
//       when it is gx - 1 (the lanes K1 reads for such a row); then the
//       <= 2R neighbour rows, all pairs. block_sum joins the sums in a
//       fixed order.
//   (b) one thread a position: the block stages its share of the Q list in
//       column order (qs ascending, qord the Q row at each entry; sorted on
//       the device by query_walk) as R1 stages the rescued list, and a
//       resident walks the slices whose columns fall in its runs.
// Exactness. Clamping is monotone and moves a key by at most one cell on
// each axis, so a pair within h, at most one cell apart on each axis of the
// unclamped keys, is at most one apart on the clamped keys: every active
// row within h of a Q row lies in the Q row's runs and the other way round,
// for my rows, for a neighbour's row outside the slab and for a straggler.
// The halo slots follow the rule the whole domain step keeps: a halo
// particle is a candidate of the boundary slab's rows only, as in K1 (a
// straggler in a halo slab more than a cell from the boundary is missed by
// K1 as well). The plain versions (ops/cuda/domain_rescue.py, the all-pairs
// sweeps of the JAX package's functions) add the same terms in another
// order and agree to a tolerance (RTOL in chip_smoke.py).
//
// What bounds it on the H100: latency, as R1 and R2. At sharded-1m a shard
// has 507,960 slots and at most 3R = 768 query rows: part (a) is a chain
// of searches, a few hundred candidates and a block sum a row of mine;
// part (b) one group search a block, then a few searches in shared memory
// a resident. The all-pairs sweep it replaces tests every slot against
// every query, ~3.9e8 pairs a half a shard.
//
// No float atomics: every sum runs in a fixed order, so two launches on
// the same inputs give the same bits. Built without --use_fast_math.

#include "sph_walk.cuh"

namespace wst {

// The column of an invalid query row: above every column plus its reach, so
// it sorts last and lies in no run (ops/cuda/domain_rescue.py::NO_COL).
constexpr int kNoCol = 1 << 30;

// The Q list in column order, as the walk reads a list (ListCols).
struct QueryList {
  const int* qs;
  const int* qord;
  __device__ __forceinline__ int operator()(int o) const { return qs[o]; }
  __device__ __forceinline__ int pos(int o) const { return qord[o]; }
};

// The halo slots in reach of a row of mine at column c: every slot of the
// lanes of c's own y/z window in the left halo slab when c's x is 0 and in
// the right one when it is gx - 1. Calls f(e) with e = slot * L + lane,
// thread t taking the items t (mod kBlock).
template <int DIM, typename F>
__device__ __forceinline__ void for_halo_slots(int c, const Cols& g, int L,
                                               int PAD, int cap_p, F&& f) {
  constexpr int MIDS = DIM == 3 ? 3 : 1;
  const int x = c / g.S_pad;
  for (int side = 0; side < 2; ++side) {
    if (x != (side == 0 ? 0 : g.gx - 1)) continue;
    // a run's columns x * S_pad + off map to the halo lanes base + off
    const int shift = (side == 0 ? PAD - g.S_pad : PAD + g.gx * g.S_pad) -
                      x * g.S_pad;
    for (int r = MIDS; r < 2 * MIDS; ++r) {  // the runs of x's own row
      int lo, hi;
      run_bounds<DIM>(c, g, r, lo, hi);
      if (lo > hi) continue;
      const int nl = hi - lo + 1;
      for (int e = threadIdx.x; e < nl * cap_p; e += kBlock) {
        f(static_cast<long long>(e / nl) * L + shift + lo + e % nl);
      }
    }
  }
}

template <int DIM>
__device__ __forceinline__ float length(const float* v) {
  float d2 = 0.f;
#pragma unroll
  for (int k = 0; k < DIM; ++k) d2 += v[k] * v[k];
  return sqrtf(d2);
}

__device__ __forceinline__ void add_density(float d, float h, float pow2,
                                            float pow3, float (&v)[2]) {
  if (d <= h) {
    const float u = h - d;
    const float u2 = u * u;
    v[0] += u2 * pow2;
    v[1] += u2 * u * pow3;
  }
}

template <int DIM>
__global__ void __launch_bounds__(kBlock)
domain_density_kernel(const float* __restrict__ pred, int n,
                      const int* __restrict__ skey,
                      const int* __restrict__ order,
                      const int* __restrict__ addr,
                      const float* __restrict__ qpos,
                      const int* __restrict__ qcol,
                      const int* __restrict__ qs,
                      const int* __restrict__ qord, int nq, int R,
                      const float* __restrict__ feats,
                      const int* __restrict__ gate,
                      const float* __restrict__ prm,
                      float* __restrict__ dens, float* __restrict__ qden,
                      float* __restrict__ qnden, long long PL, Cols g, int L,
                      int PAD, int cap_p, int blocks_a) {
  if (*gate <= 0) return;  // the gate: no valid query row this step
  const float h = prm[P_H];
  const float pow2 = prm[P_POW2];
  const float pow3 = prm[P_POW3];
  const int blocks_b = (n + kBlock - 1) / kBlock;

  if (static_cast<int>(blockIdx.x) >= blocks_b) {
    // (a) a row of mine: its exact sums, itself included
    __shared__ float red[2 * kWarps];
    __shared__ int rb[2 * kRuns<DIM>];
    for (int o = blockIdx.x - blocks_b; o < R; o += blocks_a) {
      const int c = qcol[o];
      if (c == kNoCol) continue;  // o is the block's: all threads skip
      find_run_rows<DIM>(skey, n, c, g, rb);
      float q[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) q[k] = qpos[o * DIM + k];
      __syncthreads();
      float v[2] = {0.f, 0.f};
      for (int r = 0; r < kRuns<DIM>; ++r) {
        const int b = rb[2 * r];
        const int e = rb[2 * r + 1];
        for (int k = b + ((static_cast<int>(threadIdx.x) - b) & (kBlock - 1));
             k < e; k += kBlock) {
          const int j = order[k];
          add_density(sqrtf(dist2<DIM>(pred + j * DIM, q)), h, pow2, pow3,
                      v);
        }
      }
      for_halo_slots<DIM>(c, g, L, PAD, cap_p, [&](long long e) {
        float p[DIM];
#pragma unroll
        for (int a = 0; a < DIM; ++a) p[a] = feats[a * PL + e];
        add_density(sqrtf(dist2<DIM>(p, q)), h, pow2, pow3, v);
      });
      for (int t = R + threadIdx.x; t < nq; t += kBlock) {
        if (qcol[t] == kNoCol) continue;
        add_density(sqrtf(dist2<DIM>(qpos + t * DIM, q)), h, pow2, pow3, v);
      }
      block_sum<2>(v, red);
      if (threadIdx.x == 0) {
        qden[o] = v[0] + kDensityPadding;
        qnden[o] = v[1] + kDensityPadding;
      }
    }
    return;
  }

  // (b) a resident's gain from the Q rows of its runs, then its six plane
  // rows; one thread a position
  __shared__ Stage st;
  const QueryList list{qs, qord};
  stage_slice(skey, list, nq, n, g, st);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n || st.first == st.last) return;
  const int j = order[k];
  const long long a = addr[j];
  if (a >= PL) return;  // dropped or inactive: not in the planes
  int ob[kRuns<DIM>], oe[kRuns<DIM>];
  if (!find_run_slices<DIM>(st, list, skey[k], g, ob, oe)) return;
  const bool staged = st.last - st.first <= kStage;
  float q[DIM];
#pragma unroll
  for (int t = 0; t < DIM; ++t) q[t] = pred[j * DIM + t];
  float v[2] = {0.f, 0.f};
  bool added = false;
#pragma unroll
  for (int r = 0; r < kRuns<DIM>; ++r) {
    for (int o = ob[r]; o < oe[r]; ++o) {
      const int qi = staged ? st.pos[o - st.first] : qord[o];
      const float d = sqrtf(dist2<DIM>(qpos + qi * DIM, q));
      added |= d <= h;
      add_density(d, h, pow2, pow3, v);
    }
  }
  // nothing added: the rows below would rewrite the values they hold
  if (!added) return;
  const float dj = dens[a] + v[0];
  const float nj = dens[PL + a] + v[1];
  const float kp = prm[P_PRESSURE];
  const float pa = kp * 0.5f;
  const float pb = -kp * prm[P_TARGET_DENSITY] * 0.5f;
  const float npa = prm[P_NEAR_PRESSURE] * 0.5f;
  dens[a] = dj;
  dens[PL + a] = nj;
  dens[2 * PL + a] = pa * dj + pb;
  dens[3 * PL + a] = npa * nj;
  dens[4 * PL + a] = 1.f / dj;
  dens[5 * PL + a] = 1.f / nj;
}

// Adds one candidate's pair force to a query row's sums f (pressure force,
// then viscosity sum): disp points from the query row to the candidate,
// dir_sign is +1 for the force on the query row and -1 for the force on
// the candidate (the +y fallback at d == 0 is taken by both).
template <int DIM>
__device__ __forceinline__ void add_force(const float* disp, float d,
                                          float dir_sign, float scale,
                                          const float* dvel, float wv,
                                          float (&f)[2 * DIM]) {
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    const float dir = d > 0.f ? dir_sign * (disp[k] / d)
                              : (k == 1 ? 1.f : 0.f);
    f[k] += dir * scale;
    f[DIM + k] += dvel[k] * wv;
  }
}

struct ForceCoeffs {
  float h, pow2_der, pow3_der, spikey, kp, knp, rho0;
};

// The pair's force scale on the side whose partner has (den, nden), and
// its viscosity weight, for two rows with EOS pressures (p1, np1), (p2,
// np2) at distance d <= h.
__device__ __forceinline__ float pair_scale(const ForceCoeffs& c, float d,
                                            float p1, float np1, float p2,
                                            float np2, float den, float nden,
                                            float& wv) {
  const PairTerms t = pair_terms(d, c.h, c.pow2_der, c.pow3_der, c.spikey);
  wv = t.wv;
  const float sh_p = (p1 + p2) * 0.5f;
  const float sh_np = (np1 + np2) * 0.5f;
  return sh_p * t.dw / den + sh_np * t.dwn / nden;
}

// Columns of the packed query rows qf (nq, 2 * DIM + 4).
template <int DIM>
struct QF {
  static constexpr int kVel = DIM, kDen = 2 * DIM, kNden = 2 * DIM + 1,
                       kPrs = 2 * DIM + 2, kNprs = 2 * DIM + 3,
                       kWidth = 2 * DIM + 4;
};

template <int DIM>
__global__ void __launch_bounds__(kBlock)
domain_force_kernel(const float* __restrict__ pred,
                    const float* __restrict__ vel,
                    const float* __restrict__ den,
                    const float* __restrict__ nden,
                    const float* __restrict__ prs,
                    const float* __restrict__ nprs, int n,
                    const int* __restrict__ skey,
                    const int* __restrict__ order,
                    const int* __restrict__ slot,
                    const float* __restrict__ qf,
                    const int* __restrict__ qrow,
                    const int* __restrict__ qcol,
                    const int* __restrict__ qs,
                    const int* __restrict__ qord, int nq, int R,
                    const float* __restrict__ feats,
                    const float* __restrict__ dens,
                    const int* __restrict__ gate,
                    const float* __restrict__ prm, float* __restrict__ acc,
                    long long PL, Cols g, int L, int PAD, int cap_p,
                    int blocks_a) {
  if (*gate <= 0) return;
  using F = QF<DIM>;
  const ForceCoeffs cf{prm[P_H],        prm[P_POW2_DER],
                       prm[P_POW3_DER], prm[P_SPIKEY],
                       prm[P_PRESSURE], prm[P_NEAR_PRESSURE],
                       prm[P_TARGET_DENSITY]};
  const float h = cf.h;
  const float visc = prm[P_VISCOSITY];
  const int blocks_b = (n + kBlock - 1) / kBlock;

  if (static_cast<int>(blockIdx.x) >= blocks_b) {
    // (a) a row of mine: its whole acceleration
    __shared__ float red[2 * DIM * kWarps];
    __shared__ int rb[2 * kRuns<DIM>];
    for (int o = blockIdx.x - blocks_b; o < R; o += blocks_a) {
      const int c = qcol[o];
      if (c == kNoCol) continue;
      const int i = qrow[o];
      find_run_rows<DIM>(skey, n, c, g, rb);
      const float* qo = qf + o * F::kWidth;
      float qp[DIM], qv[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        qp[k] = qo[k];
        qv[k] = qo[F::kVel + k];
      }
      const float qprs = qo[F::kPrs];
      const float qnprs = qo[F::kNprs];
      __syncthreads();
      float f[2 * DIM];
#pragma unroll
      for (int k = 0; k < 2 * DIM; ++k) f[k] = 0.f;
      // one candidate within h: its velocity cv, densities (made safe) and
      // EOS pressures, at distance d along disp
      auto add = [&](const float* cv, float cden, float cnden, float cprs,
                     float cnprs, float d, const float* disp) {
        float wv;
        const float scale =
            pair_scale(cf, d, qprs, qnprs, cprs, cnprs, cden, cnden, wv);
        float dvel[DIM];
#pragma unroll
        for (int k = 0; k < DIM; ++k) dvel[k] = cv[k] - qv[k];
        add_force<DIM>(disp, d, 1.f, scale, dvel, wv, f);
      };
      for (int r = 0; r < kRuns<DIM>; ++r) {
        const int b = rb[2 * r];
        const int e = rb[2 * r + 1];
        for (int kk = b + ((static_cast<int>(threadIdx.x) - b) & (kBlock - 1));
             kk < e; kk += kBlock) {
          const int j = order[kk];
          float disp[DIM];  // o -> j
#pragma unroll
          for (int k = 0; k < DIM; ++k) disp[k] = pred[j * DIM + k] - qp[k];
          const float d = length<DIM>(disp);
          if (d > h || j == i || slot[j] >= R) continue;
          add(vel + j * DIM, den[j] > 0.f ? den[j] : 1.f,
              nden[j] > 0.f ? nden[j] : 1.f, prs[j], nprs[j], d, disp);
        }
      }
      for_halo_slots<DIM>(c, g, L, PAD, cap_p, [&](long long e) {
        float p[DIM], cv[DIM], disp[DIM];
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          p[k] = feats[k * PL + e];
          disp[k] = p[k] - qp[k];
        }
        const float d = length<DIM>(disp);
        if (d > h) return;
#pragma unroll
        for (int k = 0; k < DIM; ++k) cv[k] = feats[(DIM + k) * PL + e];
        const float dr = dens[e];
        const float nr = dens[PL + e];
        add(cv, dr > 0.f ? dr : 1.f, nr > 0.f ? nr : 1.f,
            cf.kp * (dr - cf.rho0), cf.knp * nr, d, disp);
      });
      for (int t = R + threadIdx.x; t < nq; t += kBlock) {
        if (qcol[t] == kNoCol) continue;
        const float* qt = qf + t * F::kWidth;
        float disp[DIM];
#pragma unroll
        for (int k = 0; k < DIM; ++k) disp[k] = qt[k] - qp[k];
        const float d = length<DIM>(disp);
        if (d > h) continue;
        add(qt + F::kVel, qt[F::kDen], qt[F::kNden], qt[F::kPrs],
            qt[F::kNprs], d, disp);
      }
      block_sum<2 * DIM>(f, red);
      if (threadIdx.x == 0) {
        const float di = qo[F::kDen];
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          acc[i * DIM + k] = f[k] / di + visc * f[DIM + k];
        }
      }
    }
    return;
  }

  // (b) a resident's correction from the Q rows of its runs
  __shared__ Stage st;
  const QueryList list{qs, qord};
  stage_slice(skey, list, nq, n, g, st);
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  if (kk >= n || st.first == st.last) return;
  const int j = order[kk];
  // inactive (keyed past the grid) or dropped: no resident
  if (skey[kk] >= g.gx * g.S_pad || slot[j] >= 0) return;
  int ob[kRuns<DIM>], oe[kRuns<DIM>];
  if (!find_run_slices<DIM>(st, list, skey[kk], g, ob, oe)) return;
  const bool staged = st.last - st.first <= kStage;
  float qp[DIM], qv[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    qp[k] = pred[j * DIM + k];
    qv[k] = vel[j * DIM + k];
  }
  const float qprs = prs[j];
  const float qnprs = nprs[j];
  float f[2 * DIM];
#pragma unroll
  for (int k = 0; k < 2 * DIM; ++k) f[k] = 0.f;
  bool added = false;
#pragma unroll
  for (int r = 0; r < kRuns<DIM>; ++r) {
    for (int o = ob[r]; o < oe[r]; ++o) {
      const int qi = staged ? st.pos[o - st.first] : qord[o];
      const float* qt = qf + qi * F::kWidth;
      float disp[DIM];  // the Q row -> j
#pragma unroll
      for (int k = 0; k < DIM; ++k) disp[k] = qp[k] - qt[k];
      const float d = length<DIM>(disp);
      if (d > h) continue;
      float wv;
      const float scale = pair_scale(cf, d, qt[F::kPrs], qt[F::kNprs], qprs,
                                     qnprs, qt[F::kDen], qt[F::kNden], wv);
      float dvel[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) dvel[k] = qt[F::kVel + k] - qv[k];
      // j's view: the direction flips, except the +y fallback at d == 0
      add_force<DIM>(disp, d, -1.f, scale, dvel, wv, f);
      added = true;
    }
  }
  if (!added) return;  // acc + 0 would be acc
  const float dj = den[j] > 0.f ? den[j] : 1.f;
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

// pred: (n, dim) f32 the shard's rows; skey: (n,) i32 the build's sorted
// keys; order: (n,) i32 the row at each position; addr: (n,) i32 plane
// addresses (cap_p * L: none); qpos: (nq, dim) f32 the query rows; qcol:
// (nq,) i32 their columns (kNoCol: invalid); qs, qord: (nq,) i32 the
// columns ascending and the query row at each; R: rows of mine (Q[0, R));
// feats: (2 * dim, cap_p, L) f32 the halo-filled planes; gate: () i32 on
// the device; prm: (16,) f32; dens: (6, cap_p, L) f32 updated in place;
// qden, qnden: (R,) f32 written at my valid rows; PAD, S_pad, gx, gy, gz:
// the shard's plane geometry (gx its slab's width; gz unused in 2-D);
// blocks_a: blocks of part (a). Launches on `stream` of `device` and
// returns cudaGetLastError().
extern "C" int wst_sph_domain_rescue_density(
    const float* pred, int n, const int* skey, const int* order,
    const int* addr, const float* qpos, const int* qcol, const int* qs,
    const int* qord, int nq, int R, const float* feats, const int* gate,
    const float* prm, float* dens, float* qden, float* qnden, int dim,
    int cap_p, int L, int PAD, int S_pad, int gx, int gy, int gz,
    int blocks_a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || R <= 0 || blocks_a <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const long long PL = static_cast<long long>(cap_p) * L;
  const wst::Cols g = wst::cols(dim, S_pad, gx, gy, gz);
  const dim3 grid(static_cast<unsigned>(rows_grid(n, blocks_a)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    wst::domain_density_kernel<3><<<grid, wst::kBlock, 0, s>>>(
        pred, n, skey, order, addr, qpos, qcol, qs, qord, nq, R, feats, gate,
        prm, dens, qden, qnden, PL, g, L, PAD, cap_p, blocks_a);
  } else if (dim == 2) {
    wst::domain_density_kernel<2><<<grid, wst::kBlock, 0, s>>>(
        pred, n, skey, order, addr, qpos, qcol, qs, qord, nq, R, feats, gate,
        prm, dens, qden, qnden, PL, g, L, PAD, cap_p, blocks_a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// pred, vel: (n, dim) f32; den, nden, prs, nprs: (n,) f32 the rows'
// corrected densities and EOS pressures; skey, order as above; slot: (n,)
// i32 a dropped row's rank among the shard's dropped rows, -1 for the
// others; qf: (nq, 2 * dim + 4) f32 the query rows (pos, vel, den, nden,
// prs, nprs); qrow: (R,) i32 my rows' local rows; qcol, qs, qord, R, feats
// as above; dens: (6, cap_p, L) f32 the exchanged density planes; acc:
// (n, dim) f32 updated in place.
extern "C" int wst_sph_domain_rescue_force(
    const float* pred, const float* vel, const float* den, const float* nden,
    const float* prs, const float* nprs, int n, const int* skey,
    const int* order, const int* slot, const float* qf, const int* qrow,
    const int* qcol, const int* qs, const int* qord, int nq, int R,
    const float* feats, const float* dens, const int* gate, const float* prm,
    float* acc, int dim, int cap_p, int L, int PAD, int S_pad, int gx, int gy,
    int gz, int blocks_a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || R <= 0 || blocks_a <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const long long PL = static_cast<long long>(cap_p) * L;
  const wst::Cols g = wst::cols(dim, S_pad, gx, gy, gz);
  const dim3 grid(static_cast<unsigned>(rows_grid(n, blocks_a)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    wst::domain_force_kernel<3><<<grid, wst::kBlock, 0, s>>>(
        pred, vel, den, nden, prs, nprs, n, skey, order, slot, qf, qrow, qcol,
        qs, qord, nq, R, feats, dens, gate, prm, acc, PL, g, L, PAD, cap_p,
        blocks_a);
  } else if (dim == 2) {
    wst::domain_force_kernel<2><<<grid, wst::kBlock, 0, s>>>(
        pred, vel, den, nden, prs, nprs, n, skey, order, slot, qf, qrow, qcol,
        qs, qord, nq, R, feats, dens, gate, prm, acc, PL, g, L, PAD, cap_p,
        blocks_a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
