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
//   0 <= slot[j] < count: j is rescued;
//   slot[j] >= count: j is dropped beyond the budget, out of the physics.
// R1 (in place on den, nden and the six density planes):
//   (a) the last blocks_a blocks: list entry o = their index, + blocks_a,
//       ... < count sums w and wn over every row within h, self included,
//       and writes den[i] = sum + DENSITY_PADDING (nden likewise);
//   (b) the first ceil(n / kBlock) blocks, one thread a row: a resident
//       adds the rescued rows' contributions and writes its six derived
//       rows (den, nden, EOS half-pressures, reciprocals) into the planes
//       at addr[j], as ops/cuda/sph_bucket.py::derived_density_planes
//       computes them; with dens null (ops/grid.py, whose bucket planes
//       have another layout) it writes den and nden only, and the caller
//       updates its planes. Dropped-but-unrescued rows keep their fill
//       values.
//   Thread 0 of block 0 adds count to `rescued` (when not null): the
//   rescued-rows counter of the graph that owns the step.
// R2 (in place on acc): the same two parts for the pair forces of every
// pair that touches a rescued row: (a) a rescued row's whole acceleration
// (self and beyond-budget rows excluded, +y at d == 0), (b) a resident's
// correction from the rescued rows, divided by its own den.
//
// The walk: a cell list over the build's sorted rows. The build
// (ops/cuda/sph_bucket.py::_build_core) sorts the rows by their clamped
// column col = x * S_pad + y * gz + z, stably, so scol[k], the column of
// the k-th row in that order, never decreases and a cell's rows are one
// contiguous run of positions. The 3^DIM neighbour cells of a column are
// 3^(DIM-1) runs of up to three adjacent columns along the innermost axis
// (z in 3-D, y in 2-D; the runs K1 walks in sph_density.cu), each axis
// clamped to the grid first (an unclamped y - 1 at a slab's edge would
// alias into the neighbouring x slab where S_pad == gy * gz), so each run
// is one range of positions, found by two lower-bound searches of scol.
//   (a) one block a rescued row: groups of 8 lanes find the run ranges
//       (group_lower_bound), then thread t takes the positions
//       k = t (mod blockDim) in ascending k, over the ranges in ascending
//       order, and the block joins the sums with block_sum's fixed tree;
//   (b) one thread a position k: the block stages the part of the rescued
//       list (kept in column order: rpos, the rescued rows' positions,
//       ascending) that its positions' neighbourhoods can reach into
//       shared memory (stage_slice); the resident at k finds there, for
//       each of its runs, the slice whose columns fall in the run, and
//       walks the slices in ascending list order. A block with no rescued
//       row in reach returns after one search; a resident with nothing
//       within h writes nothing (its rows would be rewritten unchanged).
// On the sorted step (order == nullptr) row k sits at position k and the
// rescued list, in row order, is already in column order: the walk visits
// the pairs of the all-pairs sweep it replaced, in the sweep's order, and
// skips only rows farther than h, for which the sweep added nothing, so
// the bits equal that sweep's. Off it (bucket_sph in particle order, the
// incremental step) order[k] names the row at position k and the wrapper
// sorts the rescued list by position; the sums then run in another order.
//
// Exactness. A pair within h lies within one cell on each axis of the
// unclamped keys, and clamping a key moves it by at most one cell in a
// monotone way, so the pair's columns lie in each other's clamped
// neighbourhoods: the walk finds every pair the sweep did. The one
// exception is rounding: floor((p - origin) / h) is taken on rounded
// coordinates (on grid_frame="container" after the box's pose), so a pair
// at d = h - eps may sit two cells apart. K1, K2 and the JAX kernels skip
// such a pair too; its terms are at most (h - d)^2 and (h - d), at
// rounding scale.
//
// No float atomics: every sum runs in a fixed order, so two launches on
// the same inputs give the same bits. Built with nvcc's default
// -fmad=true: products and sums contract into FMAs, one more reason
// besides the summation order why the plain version (the all-pairs sweep
// of ops/rescue.py) agrees to a tolerance (RTOL in chip_smoke.py), not to
// the bit.
//
// What bounds it on the H100: latency. The work is small, ~150 candidate
// rows a rescued row at reference-cube, but each step is a chain of
// dependent loads: a search, then the candidates, then the block's sum.
// (a) searches with 8 lanes a bound, ~log8(n) steps of one load, and
// overlaps the rescued rows of many blocks; (b) searches the block's
// share of the list once and the runs in shared memory, all bounds at
// once (lower_bounds). Timed on the H100 and left out (PERF.md):
// each thread searching the whole list (slower at small counts, even at
// thousands of rows), part (a)'s bounds by one lane each (R2 slower,
// R1 even), and __launch_bounds__ minima of 6 or 8 blocks an SM (spills,
// R2 slower).

#include "sph_walk.cuh"

namespace wst {

template <int DIM>
__global__ void __launch_bounds__(kBlock)
rescue_density_kernel(const float* __restrict__ pred, int n,
                      const int* __restrict__ scol,
                      const int* __restrict__ order,
                      const int* __restrict__ rpos,
                      const int* __restrict__ slot,
                      const int* __restrict__ count_ptr,
                      const int* __restrict__ addr,
                      const float* __restrict__ prm, float* __restrict__ den,
                      float* __restrict__ nden, float* __restrict__ dens,
                      long long* __restrict__ rescued, long long PL, Cols g,
                      int blocks_a) {
  const int count = *count_ptr;
  if (count <= 0) return;  // the gate: nothing to rescue this step
  if (rescued != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    *rescued += count;  // the one writer: the owner's running total
  }
  const float h = prm[P_H];
  const float pow2 = prm[P_POW2];
  const float pow3 = prm[P_POW3];
  const int blocks_b = (n + kBlock - 1) / kBlock;

  if (static_cast<int>(blockIdx.x) >= blocks_b) {
    // (a) a rescued row's exact sums over the rows of its runs, self
    // included
    __shared__ float red[2 * kWarps];
    __shared__ int rb[2 * kRuns<DIM>];
    for (int o = blockIdx.x - blocks_b; o < count; o += blocks_a) {
      const int p = rpos[o];
      const int i = order ? order[p] : p;
      find_run_rows<DIM>(scol, n, scol[p], g, rb);
      float q[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) q[k] = pred[i * DIM + k];
      __syncthreads();
      float v[2] = {0.f, 0.f};
      for (int r = 0; r < kRuns<DIM>; ++r) {
        const int b = rb[2 * r];
        const int e = rb[2 * r + 1];
        // the positions = threadIdx.x (mod kBlock), as the sweep's j
        for (int k = b + ((static_cast<int>(threadIdx.x) - b) & (kBlock - 1));
             k < e; k += kBlock) {
          const int j = order ? order[k] : k;
          float pj[DIM];
#pragma unroll
          for (int a = 0; a < DIM; ++a) pj[a] = pred[j * DIM + a];
          const float d = sqrtf(dist2<DIM>(pj, q));
          if (d <= h) {
            const float u = h - d;
            const float u2 = u * u;
            v[0] += u2 * pow2;
            v[1] += u2 * u * pow3;
          }
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

  // (b) a resident's gain from the rescued rows of its runs, then its six
  // plane rows; one thread a position, a warp's lanes search together
  __shared__ Stage st;
  stage_slice(scol, ListCols{scol, rpos}, count, n, g, st);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n || st.first == st.last) return;
  const int j = order ? order[k] : k;
  if (slot[j] >= 0) return;  // rescued or dropped: not in the planes
  int ob[kRuns<DIM>], oe[kRuns<DIM>];
  if (!find_run_slices<DIM>(st, ListCols{scol, rpos}, scol[k], g, ob, oe)) {
    return;  // no rescued row nearby: den, nden and the planes stay
  }
  const bool staged = st.last - st.first <= kStage;
  float q[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) q[a] = pred[j * DIM + a];
  float w = 0.f, wn = 0.f;
  bool added = false;
#pragma unroll
  for (int r = 0; r < kRuns<DIM>; ++r) {
    for (int o = ob[r]; o < oe[r]; ++o) {
      const int p = staged ? st.pos[o - st.first] : rpos[o];
      const int i = order ? order[p] : p;
      float pi[DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a) pi[a] = pred[i * DIM + a];
      const float d = sqrtf(dist2<DIM>(pi, q));
      if (d <= h) {
        const float u = h - d;
        const float u2 = u * u;
        w += u2 * pow2;
        wn += u2 * u * pow3;
        added = true;
      }
    }
  }
  // nothing added: the rows below would rewrite the values they hold (K1
  // writes the planes from den and nden by the same expressions)
  if (!added) return;
  const float dj = den[j] + w;
  const float nj = nden[j] + wn;
  den[j] = dj;
  nden[j] = nj;
  if (dens == nullptr) return;  // the caller's planes
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


template <int DIM>
__global__ void __launch_bounds__(kBlock)
rescue_force_kernel(const float* __restrict__ pred,
                    const float* __restrict__ vel,
                    const float* __restrict__ den,
                    const float* __restrict__ nden,
                    const float* __restrict__ prs,
                    const float* __restrict__ nprs, int n,
                    const int* __restrict__ scol,
                    const int* __restrict__ order,
                    const int* __restrict__ rpos,
                    const int* __restrict__ slot,
                    const int* __restrict__ count_ptr,
                    const float* __restrict__ prm, float* __restrict__ acc,
                    Cols g, int blocks_a) {
  const int count = *count_ptr;
  if (count <= 0) return;
  const float h = prm[P_H];
  const float pow2_der = prm[P_POW2_DER];
  const float pow3_der = prm[P_POW3_DER];
  const float spikey = prm[P_SPIKEY];
  const float visc = prm[P_VISCOSITY];
  const int blocks_b = (n + kBlock - 1) / kBlock;

  if (static_cast<int>(blockIdx.x) >= blocks_b) {
    // (a) a rescued row's whole acceleration, over the rows of its runs
    __shared__ float red[2 * DIM * kWarps];
    __shared__ int rb[2 * kRuns<DIM>];
    for (int o = blockIdx.x - blocks_b; o < count; o += blocks_a) {
      const int p = rpos[o];
      const int i = order ? order[p] : p;
      find_run_rows<DIM>(scol, n, scol[p], g, rb);
      float qp[DIM], qv[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        qp[k] = pred[i * DIM + k];
        qv[k] = vel[i * DIM + k];
      }
      const float qprs = prs[i];
      const float qnprs = nprs[i];
      __syncthreads();
      float f[2 * DIM];  // pressure force, then viscosity sum
#pragma unroll
      for (int k = 0; k < 2 * DIM; ++k) f[k] = 0.f;
      for (int r = 0; r < kRuns<DIM>; ++r) {
        const int b = rb[2 * r];
        const int e = rb[2 * r + 1];
        for (int kk = b + ((static_cast<int>(threadIdx.x) - b) & (kBlock - 1));
             kk < e; kk += kBlock) {
          const int j = order ? order[kk] : kk;
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

  // (b) a resident's correction from the rescued rows of its runs
  __shared__ Stage st;
  stage_slice(scol, ListCols{scol, rpos}, count, n, g, st);
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  if (kk >= n || st.first == st.last) return;
  const int j = order ? order[kk] : kk;
  if (slot[j] >= 0) return;
  int ob[kRuns<DIM>], oe[kRuns<DIM>];
  if (!find_run_slices<DIM>(st, ListCols{scol, rpos}, scol[kk], g, ob,
                            oe)) {
    return;  // no rescued row nearby: acc stays
  }
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
      const int p = staged ? st.pos[o - st.first] : rpos[o];
      const int i = order ? order[p] : p;
      float disp[DIM];  // o -> j
#pragma unroll
      for (int k = 0; k < DIM; ++k) disp[k] = qp[k] - pred[i * DIM + k];
      float d2 = 0.f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) d2 += disp[k] * disp[k];
      const float d = sqrtf(d2);
      if (d > h) continue;
      const PairTerms pt = pair_terms(d, h, pow2_der, pow3_der, spikey);
      const float sh_p = (prs[i] + qprs) * 0.5f;
      const float sh_np = (nprs[i] + qnprs) * 0.5f;
      const float scale = sh_p * pt.dw / den[i] + sh_np * pt.dwn / nden[i];
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        // j's view: the direction flips, except the +y fallback at d == 0
        const float dir = d > 0.f ? -(disp[k] / d) : (k == 1 ? 1.f : 0.f);
        f[k] += dir * scale;
        f[DIM + k] += (vel[i * DIM + k] - qv[k]) * pt.wv;
      }
      added = true;
    }
  }
  if (!added) return;  // acc + 0 would be acc
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

// pred: (n, dim) f32 rows; scol: (n,) i32 the rows' columns in ascending
// order; order: (n,) i32 the row at each position, or null when row k is
// at position k; rpos: (cap,) i32 the rescued rows' positions, ascending
// over [0, count); slot: (n,) i32; count: () i32 on the device; addr: (n,)
// i32 plane addresses; prm: (16,) f32; den, nden: (n,) f32 and dens: (6,
// cap_p, L) f32, all three updated in place (addr and dens may both be
// null: then den and nden only); rescued: () i64 on the device, which
// gains count, or null; S_pad, gx, gy, gz: the column
// keys' grid (gz unused in 2-D); blocks_a: blocks of part (a). Launches on
// `stream` of `device` and returns cudaGetLastError().
extern "C" int wst_sph_rescue_density(const float* pred, int n,
                                      const int* scol, const int* order,
                                      const int* rpos, const int* slot,
                                      const int* count, const int* addr,
                                      const float* prm, float* den,
                                      float* nden, float* dens,
                                      long long* rescued, int dim,
                                      int cap_p, int L, int S_pad, int gx,
                                      int gy, int gz, int blocks_a,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || blocks_a <= 0) return static_cast<int>(cudaGetLastError());
  const long long PL = static_cast<long long>(cap_p) * L;
  const wst::Cols g = wst::cols(dim, S_pad, gx, gy, gz);
  const dim3 grid(static_cast<unsigned>(rows_grid(n, blocks_a)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    wst::rescue_density_kernel<3><<<grid, wst::kBlock, 0, s>>>(
        pred, n, scol, order, rpos, slot, count, addr, prm, den, nden, dens,
        rescued, PL, g, blocks_a);
  } else if (dim == 2) {
    wst::rescue_density_kernel<2><<<grid, wst::kBlock, 0, s>>>(
        pred, n, scol, order, rpos, slot, count, addr, prm, den, nden, dens,
        rescued, PL, g, blocks_a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// pred, vel: (n, dim) f32; den, nden, prs, nprs: (n,) f32; scol, order,
// rpos, slot, count as above; prm: (16,) f32; acc: (n, dim) f32 updated in
// place.
extern "C" int wst_sph_rescue_force(const float* pred, const float* vel,
                                    const float* den, const float* nden,
                                    const float* prs, const float* nprs,
                                    int n, const int* scol, const int* order,
                                    const int* rpos, const int* slot,
                                    const int* count, const float* prm,
                                    float* acc, int dim, int S_pad, int gx,
                                    int gy, int gz, int blocks_a, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || blocks_a <= 0) return static_cast<int>(cudaGetLastError());
  const wst::Cols g = wst::cols(dim, S_pad, gx, gy, gz);
  const dim3 grid(static_cast<unsigned>(rows_grid(n, blocks_a)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    wst::rescue_force_kernel<3><<<grid, wst::kBlock, 0, s>>>(
        pred, vel, den, nden, prs, nprs, n, scol, order, rpos, slot, count,
        prm, acc, g, blocks_a);
  } else if (dim == 2) {
    wst::rescue_force_kernel<2><<<grid, wst::kBlock, 0, s>>>(
        pred, vel, den, nden, prs, nprs, n, scol, order, rpos, slot, count,
        prm, acc, g, blocks_a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
