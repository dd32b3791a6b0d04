// The bucket build after the sort, in one launch: slot ranks, the sorted
// row gather, the plane scatter, the per-lane counts and the overflow.
//
// Replaces no TPU kernel: the JAX package builds with XLA ops
// (water_sandbox_tpu/ops/pallas/sph_bucket.py::_build_core, :268-318, a
// jax.lax.cummax over the sorted keys, one row gather and the "stack"
// scatter). It takes the place of the port's ATen chain for the same steps,
// ops/cuda/build.py::build_plain, and must equal it bit for bit: every
// output is a copy or an integer worked out from the sorted keys.
//
// Row i of the sort (key c = sorted_col[i], source row o = order[i]):
//   slot    = i - (first row of c's run), exact below cap;
//   ok      = slot < cap && c < end;
//   flat[i] = ok ? slot * L + pad + c : cap_p * L;
//   srows[i] = (pred[o], vel[o], carry0[o], carry1[o]), order_out[i] = o;
//   planes[j, slot, pad + c] = srows[i, j] for j < 2 * DIM where ok;
//   counts[pad + c] += 1 where ok and pred[o].x < _FAR / 2 (so a NaN row is
//     left out, as the plain chain's (planes[0] < _FAR / 2).sum());
//   *overflow += 1 where !ok and c < end.
// The wrapper fills the planes (_FAR in the position half, 0 in the
// velocity half) and zeroes counts and overflow before the launch.
//
// What bounds it on the H100: bytes. The fill of the planes dominates the
// build (6 x 16 x 337,920 f32 at the flagship, 130 MB, done by the
// wrapper's two fills); this kernel moves the rows (read through the
// permutation and written sorted, 2 x 10.6 MB at the flagship), the keys
// and the permutation (3 MB) and one 4-byte store a feature a row into the
// planes, scattered slot by slot.
//
// Design.
// * The slot without a scan. The keys are sorted, so the first row of i's
//   run is the lower bound of c in sorted_col[max(0, i - cap), i]: a binary
//   search over at most cap + 1 keys, in the cache lines the neighbouring
//   threads read. Where that bound is i - cap itself the run started
//   earlier still and the row has no slot (slot >= cap), so the slot is
//   exact wherever it is used, and no pass over all n keys (torch.cummax's
//   single-block scan) is needed.
// * One thread a sorted row, which does all of that row's work: the gather
//   and the plane stores come from the same registers, so no (n, 2 * DIM)
//   feature buffer, cat or stack is written. The data is copied as 32-bit
//   words and never as floats: the carried ids are bit-cast int32.
// * The sorted rows leave a block as one contiguous stretch: each thread
//   puts its row into shared memory and the block copies the stretch out
//   word by word. Stored straight from each thread (a 40-byte row a
//   thread at the flagship, 10 stores that each touch 40 sectors a warp)
//   the kernel took 0.051 device ms at the settled flagship, staged 0.028.
// * Counts without a run walk: each warp groups its counted rows by lane
//   (__match_any_sync; the rows are sorted, so a lane's rows are
//   neighbours) and one thread of a group adds the group's size with a
//   float atomic. Counts are small integers, exact in f32, so the order of
//   the adds cannot change the bits. The overflow is a warp ballot and one
//   integer atomic a warp.
// * `end` bounds the keys that take a slot (keys >= end never do and are
//   not counted as overflow): the domain step's per-shard build sorts its
//   inactive rows last under key end. The single-device build passes
//   INT_MAX.

#include "sph_common.cuh"

namespace wst {

// _FAR * 0.5 (sph_bucket.py) in f32, the counts' occupancy test.
constexpr float kFarHalf = 5.0e14f;

template <int DIM>
__global__ void __launch_bounds__(kBlock) sph_build_kernel(
    const int* __restrict__ sorted_col, const long long* __restrict__ order,
    const unsigned* __restrict__ pred, const unsigned* __restrict__ vel,
    const unsigned* __restrict__ carry0, int k0,
    const unsigned* __restrict__ carry1, int k1,
    unsigned* __restrict__ planes, float* __restrict__ counts,
    int* __restrict__ flat, int* __restrict__ order_out,
    unsigned* __restrict__ srows, int* __restrict__ overflow, int n, int cap,
    int cap_p, int L, int pad, int end) {
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ unsigned tile[];
  const int w = 2 * DIM + k0 + k1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  bool ok = false;
  bool counted = false;
  int c = -1;
  if (live) {
    c = __ldg(sorted_col + i);
    int lo = max(0, i - cap);
    int hi = i;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(sorted_col + mid) < c) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int slot = i - lo;
    ok = slot < cap && c < end;
    const int lane = pad + c;
    flat[i] = ok ? slot * L + lane : cap_p * L;
    const long long o = __ldg(order + i);
    order_out[i] = static_cast<int>(o);
    unsigned x[2 * DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      x[d] = __ldg(pred + o * DIM + d);
      x[DIM + d] = __ldg(vel + o * DIM + d);
    }
    unsigned* row = tile + threadIdx.x * w;
#pragma unroll
    for (int j = 0; j < 2 * DIM; ++j) row[j] = x[j];
    for (int j = 0; j < k0; ++j) {
      row[2 * DIM + j] = __ldg(carry0 + o * k0 + j);
    }
    for (int j = 0; j < k1; ++j) {
      row[2 * DIM + k0 + j] = __ldg(carry1 + o * k1 + j);
    }
    if (ok) {
      const long long plane = static_cast<long long>(cap_p) * L;
      unsigned* at = planes + static_cast<long long>(slot) * L + lane;
#pragma unroll
      for (int j = 0; j < 2 * DIM; ++j) at[j * plane] = x[j];
      counted = __uint_as_float(x[0]) < kFarHalf;
    }
  }
  __syncthreads();
  // the block's rows out of shared memory: n - first of them in the last
  // block
  const int first = blockIdx.x * blockDim.x;
  const int words = min(static_cast<int>(blockDim.x), n - first) * w;
  unsigned* out = srows + static_cast<long long>(first) * w;
  for (int k = threadIdx.x; k < words; k += blockDim.x) out[k] = tile[k];
  const int me = threadIdx.x & 31;
  const unsigned dropped = __ballot_sync(kAll, live && !ok && c < end);
  if (me == 0 && dropped != 0) {
    atomicAdd(overflow, static_cast<int>(__popc(dropped)));
  }
  const unsigned peers = __match_any_sync(kAll, counted ? c : -1);
  if (counted && me == __ffs(peers) - 1) {
    atomicAdd(counts + pad + c, static_cast<float>(__popc(peers)));
  }
}

// Shared memory a block stages its sorted rows in: kBlock rows of
// 2 * DIM + k0 + k1 words, at most the 48 KB a launch takes without an
// opt-in (48 words a row).
template <int DIM>
cudaError_t launch_build(const int* sorted_col, const long long* order,
                         const unsigned* pred, const unsigned* vel,
                         const unsigned* carry0, int k0,
                         const unsigned* carry1, int k1, unsigned* planes,
                         float* counts, int* flat, int* order_out,
                         unsigned* srows, int* overflow, int n, int cap,
                         int cap_p, int L, int pad, int end,
                         cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n + kBlock - 1) / kBlock));
  const size_t smem = sizeof(unsigned) * kBlock * (2 * DIM + k0 + k1);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  sph_build_kernel<DIM><<<grid, kBlock, smem, s>>>(
      sorted_col, order, pred, vel, carry0, k0, carry1, k1, planes, counts,
      flat, order_out, srows, overflow, n, cap, cap_p, L, pad, end);
  return cudaGetLastError();
}

}  // namespace wst

// sorted_col: (n,) i32 non-decreasing keys; order: (n,) i64 the sort's
// permutation; pred, vel: (n, dim) f32; carry0, carry1: (n, k0), (n, k1)
// 32-bit columns (null where k is 0); planes: (2 * dim, cap_p, L) f32, filled;
// counts: (L,) f32 and overflow: () i32, zeroed; flat, order_out: (n,) i32;
// srows: (n, 2 * dim + k0 + k1), at most 48 words a row. Keys >= end take
// no slot. Launches on `stream` of `device` and returns cudaGetLastError().
extern "C" int wst_sph_build(const int* sorted_col, const long long* order,
                             const float* pred, const float* vel,
                             const float* carry0, int k0, const float* carry1,
                             int k1, float* planes, float* counts, int* flat,
                             int* order_out, float* srows, int* overflow,
                             int n, int dim, int cap, int cap_p, int L,
                             int pad, int end, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = reinterpret_cast<const unsigned*>(pred);
  const auto* v = reinterpret_cast<const unsigned*>(vel);
  const auto* c0 = reinterpret_cast<const unsigned*>(carry0);
  const auto* c1 = reinterpret_cast<const unsigned*>(carry1);
  auto* pl = reinterpret_cast<unsigned*>(planes);
  auto* sr = reinterpret_cast<unsigned*>(srows);
  if (dim == 3) {
    err = wst::launch_build<3>(sorted_col, order, p, v, c0, k0, c1, k1, pl,
                               counts, flat, order_out, sr, overflow, n, cap,
                               cap_p, L, pad, end, s);
  } else if (dim == 2) {
    err = wst::launch_build<2>(sorted_col, order, p, v, c0, k0, c1, k1, pl,
                               counts, flat, order_out, sr, overflow, n, cap,
                               cap_p, L, pad, end, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
