// The cell-list walk shared by the rescue kernels (sph_rescue.cu, R1 and
// R2; sph_domain_rescue.cu, D1 and D2): the column keys' grid and a
// column's clamped neighbour runs, the lower-bound searches over a sorted
// column array (a lane's, a group of lanes', several keys at once), the
// staging of a block's share of a list kept in column order, the block's
// fixed-order sum and the pair-force terms. sph_rescue.cu describes the
// walk and why it is exact.
#pragma once

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
  __syncthreads();  // red and the run ranges are reused by the next slot
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

// The column keys' grid: col = x * S_pad + m * gz + z with the run along
// z. In 3-D m = y (n_mid = gy) and n_in = gz; in 2-D gz == 1, m = 0
// (n_mid = 1) and the run is along y (n_in = gy).
struct Cols {
  int S_pad, gz, gx, n_mid, n_in;
};

template <int DIM>
constexpr int kRuns = DIM == 3 ? 9 : 3;

// Run r of column c's clamped neighbourhood as inclusive columns [lo, hi],
// x outermost; lo > hi where the run's cell row lies outside the grid.
template <int DIM>
__device__ __forceinline__ void run_bounds(int c, const Cols& g, int r,
                                           int& lo, int& hi) {
  constexpr int MIDS = DIM == 3 ? 3 : 1;
  const int x = c / g.S_pad;
  const int rem = c - x * g.S_pad;
  const int m = DIM == 3 ? rem / g.gz : 0;
  const int z = rem - m * g.gz;
  const int xx = x + r / MIDS - 1;
  const int mm = m + r % MIDS - (DIM == 3 ? 1 : 0);
  if (xx < 0 || xx >= g.gx || mm < 0 || mm >= g.n_mid) {
    lo = 1;
    hi = 0;
    return;
  }
  const int base = xx * g.S_pad + mm * g.gz;
  lo = base + max(z - 1, 0);
  hi = base + min(z + 1, g.n_in - 1);
}

// A list walked in column order: list(o) is entry o's column (ascending
// over the list), list.pos(o) what the walk reads at it. The rescued list:
// the rescued rows' positions rpos, their columns scol[rpos[o]].
struct ListCols {
  const int* scol;
  const int* rpos;
  __device__ __forceinline__ int operator()(int o) const {
    return scol[rpos[o]];
  }
  __device__ __forceinline__ int pos(int o) const { return rpos[o]; }
};

struct RowCols {
  const int* scol;
  __device__ __forceinline__ int operator()(int k) const { return scol[k]; }
};

// The lower bounds of K keys in [first, last) at once: pos[r] = the first
// position whose column is >= key[r] (last if none). Branch-free halving
// (Khuong and Morin's search): every key takes the same steps, so the K
// chains of dependent loads overlap instead of running one after another.
template <int K, typename Col>
__device__ __forceinline__ void lower_bounds(Col col, int first, int last,
                                             const int (&key)[K],
                                             int (&pos)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) pos[r] = first;
  int len = last - first;
  if (len <= 0) return;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      pos[r] = col(pos[r] + half) < key[r] ? pos[r] + half : pos[r];
    }
    len -= half;
  }
#pragma unroll
  for (int r = 0; r < K; ++r) pos[r] += col(pos[r]) < key[r];
}

constexpr unsigned kFull = 0xffffffffu;

// A search by a group of G lanes (G divides 32, groups aligned in the
// warp): each group finds the lower bound of its key (uniform in the
// group) in [first, last) (also uniform), the first position whose column
// is >= key. Each step tests G evenly spread positions at once and keeps
// the bracket between the last one below the key and the next, so a
// search takes ~log_G(last - first) steps of one load a lane, not
// log_2 of them one after another. Every lane of the warp must call it.
template <int G, typename Col>
__device__ __forceinline__ int group_lower_bound(Col col, int first,
                                                 int last, int key) {
  const int lane = threadIdx.x & 31;
  const int i = lane & (G - 1);
  const unsigned gmask =
      (G == 32 ? kFull : ((1u << G) - 1u)) << (lane & ~(G - 1));
  int lo = first, hi = last;  // the answer lies in [lo, hi]
  while (__any_sync(kFull, lo < hi)) {
    const int len = hi - lo;
    const bool below = lo < hi && col(lo + i * len / G) < key;
    const int cnt = __popc(__ballot_sync(kFull, below) & gmask);
    if (lo < hi) {
      // positions lo + m * len / G below the key for m < cnt only
      const int next = cnt < G ? lo + cnt * len / G : hi;
      lo = cnt == 0 ? lo : lo + (cnt - 1) * len / G + 1;
      hi = cnt == 0 ? lo : next;
    }
  }
  return lo;
}

// Part (a)'s ranges: rb[2r], rb[2r + 1] = the positions of run r of
// column c, each bound found by a group of 8 lanes of the first warps; the
// caller synchronises before reading rb.
template <int DIM>
__device__ __forceinline__ void find_run_rows(const int* __restrict__ scol,
                                              int n, int c, const Cols& g,
                                              int* rb) {
  constexpr int G = 8;
  constexpr int KEYS = 2 * kRuns<DIM>;
  const int t = threadIdx.x;
  if (t < 32 * ((KEYS * G + 31) / 32)) {  // whole warps
    const int b = t / G;                  // this group's bound
    int lo = 1, hi = 0;
    if (b < KEYS) run_bounds<DIM>(c, g, b >> 1, lo, hi);
    const bool valid = lo <= hi;          // else an empty range [0, 0)
    const int pos = group_lower_bound<G>(RowCols{scol}, 0, valid ? n : 0,
                                         (b & 1) ? hi + 1 : lo);
    if (b < KEYS && t % G == 0) rb[b] = pos;
  }
}

// Part (b)'s share of a list (ListCols' interface), for a block of
// positions: the entries whose columns can lie in the neighbourhood of one
// of the block's columns. The positions are in column order, so that is
// the slice of the list from the first position's column less the reach of
// a neighbour (S_pad + gz + 1) to the last one's plus it; warp 0 finds it
// by two group searches, and when it fits the block stages the entries'
// columns and positions into shared memory, where the threads' own
// searches run.
constexpr int kStage = 1024;

struct Stage {
  int first, last;   // the slice [first, last) of the rescued list
  int col[kStage];   // list(first + t)
  int pos[kStage];   // list.pos(first + t)
};

struct StagedCols {
  const int* col;
  int first;
  __device__ __forceinline__ int operator()(int o) const {
    return col[o - first];
  }
};

// Every thread of the block must call it; returns with st filled and
// synchronised. An empty slice (first == last) means no resident of the
// block has a rescued row nearby.
template <typename List>
__device__ __forceinline__ void stage_slice(const int* __restrict__ scol,
                                            List list, int count, int n,
                                            const Cols& g, Stage& st) {
  if (threadIdx.x < 32) {
    const int k0 = blockIdx.x * kBlock;
    const int k1 = min(n, k0 + kBlock) - 1;
    const int reach = g.S_pad + g.gz + 1;
    const int key = threadIdx.x < 16 ? scol[k0] - reach : scol[k1] + reach + 1;
    const int at = group_lower_bound<16>(list, 0, count, key);
    if (threadIdx.x == 0) st.first = at;
    if (threadIdx.x == 16) st.last = at;
  }
  __syncthreads();
  const int first = st.first;
  const int m = st.last - first;
  if (m <= kStage) {
    for (int t = threadIdx.x; t < m; t += kBlock) {
      st.pos[t] = list.pos(first + t);
      st.col[t] = list(first + t);
    }
  }
  __syncthreads();
}

// A resident's run slices [ob[r], oe[r]) of the list (list indices),
// searched all at once inside the block's slice (staged or not); returns
// whether any is non-empty.
template <int DIM, typename List>
__device__ __forceinline__ bool find_run_slices(const Stage& st,
                                                List list, int c,
                                                const Cols& g,
                                                int (&ob)[kRuns<DIM>],
                                                int (&oe)[kRuns<DIM>]) {
  constexpr int R = kRuns<DIM>;
  int lo[R], hi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    run_bounds<DIM>(c, g, r, lo[r], hi[r]);
    // a run outside the grid searches [c, c): an empty slice
    const bool v = lo[r] <= hi[r];
    hi[r] = v ? hi[r] + 1 : c;
    lo[r] = v ? lo[r] : c;
  }
  if (st.last - st.first <= kStage) {
    const StagedCols col{st.col, st.first};
    lower_bounds<R>(col, st.first, st.last, lo, ob);
    lower_bounds<R>(col, st.first, st.last, hi, oe);
  } else {
    lower_bounds<R>(list, st.first, st.last, lo, ob);
    lower_bounds<R>(list, st.first, st.last, hi, oe);
  }
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) any |= ob[r] < oe[r];
  return any;
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

inline Cols cols(int dim, int S_pad, int gx, int gy, int gz) {
  return dim == 3 ? Cols{S_pad, gz, gx, gy, gz} : Cols{S_pad, 1, gx, 1, gy};
}

}  // namespace wst
