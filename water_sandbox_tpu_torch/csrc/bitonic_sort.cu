// Ascending bitonic sort of int32 (key, value) pairs, out of place, in one
// launch.
//
// Replaces the TPU kernel water_sandbox_tpu/ops/pallas/bitonic_sort.py::
// _sort_kernel (launched by sort_pairs, used by argsort_keys). It runs the
// same network on the same padded array: n pairs padded with
// (INT32_MAX, 0) to n_pad = max(1024, next power of two) <= 65,536;
// d = 2 ... n_pad, k = d/2 ... 1, partner i ^ k; element i takes its
// partner's pair iff it should hold the pair's minimum (its index and the
// d-block's direction agree) and the partner's key is strictly smaller, or
// the maximum and strictly larger. With strict comparisons equal keys never
// move, so a pair swaps as a whole or not at all, and keys AND values come
// out bit for bit as the TPU kernel's, ties included. A real INT32_MAX key
// ties with the padding, so the padding is made here exactly as there.
//
// Design. The TPU kernel holds all n_pad pairs in VMEM. Here one block
// holds up to 8,192 pairs (64 KB of dynamic shared memory, 1,024 threads,
// 8 consecutive pairs a thread in registers), and a larger array is a
// thread-block cluster of n_pad / 8,192 blocks (2-8, the portable limit)
// that reach each other's shared memory. The stages split by partner
// distance k:
//   * k < 8: inside a thread's registers;
//   * 8 <= k < 256: warp shuffles, partner lane ^ (k / 8);
//   * 256 <= k < 8,192: in place in the block's shared memory, one
//     __syncthreads() a stage;
//   * k >= 8,192: through the cluster's distributed shared memory: every
//     element reads its partner in block rank ^ (k / 8,192), cluster.sync(),
//     writes its own, cluster.sync(). 6 of the 136 stages at 65,536.
// The padding is made in shared memory and only the n real positions are
// read and written in device memory, so the wrapper needs no torch op
// beyond allocating the outputs.
//
// What bounds it on the H100: not memory (n * 16 bytes move once, 0.3 us
// at 65,536) but the 136 dependent stages: shuffles and shared-memory
// traffic on at most 8 SMs, and the cluster barriers.

#include <atomic>
#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace wst {

constexpr int kBlockPairs = 8192;  // pairs a block holds
constexpr int kPerThread = 8;      // consecutive pairs a thread holds
constexpr int kSortThreads = kBlockPairs / kPerThread;
constexpr int kMaxPairs = 65536;   // 8 blocks, the portable cluster limit
constexpr int kMinPairs = 1024;    // the JAX package's smallest n_pad
constexpr int kMaxDevices = 64;    // device ordinals the launcher takes

// Index of the lower element of pair p at partner distance k: p with a 0
// bit inserted at bit position log2(k).
__device__ __forceinline__ int lower_index(int p, int k) {
  return ((p & ~(k - 1)) << 1) | (p & (k - 1));
}

// The exchange rule for one element: take the partner's pair?
__device__ __forceinline__ bool takes(int mine, int other, bool want_min) {
  return want_min ? other < mine : other > mine;
}

// A thread's 8 consecutive pairs to or from shared memory, 16 bytes at a
// time (the rows start 32-byte aligned).
__device__ __forceinline__ void load8(const int* s, int* r) {
  const int4 a = reinterpret_cast<const int4*>(s)[0];
  const int4 b = reinterpret_cast<const int4*>(s)[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}
__device__ __forceinline__ void store8(int* s, const int* r) {
  reinterpret_cast<int4*>(s)[0] = make_int4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<int4*>(s)[1] = make_int4(r[4], r[5], r[6], r[7]);
}

__global__ void __launch_bounds__(kSortThreads)
bitonic_sort_cluster(const int* __restrict__ in_k,
                     const int* __restrict__ in_v, int* __restrict__ out_k,
                     int* __restrict__ out_v, int n, int n_pad) {
  extern __shared__ __align__(16) int smem[];
  const int E = n_pad < kBlockPairs ? n_pad : kBlockPairs;
  int* sk = smem;
  int* sv = smem + E;
  const int nt = blockDim.x;  // E / kPerThread
  const int t = threadIdx.x;
  const int base = blockIdx.x * E;  // the grid is one cluster
  const int mine = base + kPerThread * t;  // global index of register 0

  // load the n real pairs coalesced; the padding is made here
  for (int e = t; e < E; e += nt) {
    const int gi = base + e;
    const bool real = gi < n;
    sk[e] = real ? in_k[gi] : INT_MAX;
    sv[e] = real ? in_v[gi] : 0;
  }
  __syncthreads();
  int key[kPerThread], val[kPerThread];
  load8(sk + kPerThread * t, key);
  load8(sv + kPerThread * t, val);

  for (int d = 2; d <= n_pad; d <<= 1) {
    int k = d >> 1;
    if (k >= 256) {
      // Each thread stores and reloads only its own 8 positions, so the
      // barriers below are the only ones the shared-memory stages need.
      store8(sk + kPerThread * t, key);
      store8(sv + kPerThread * t, val);
      if (k >= E) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        // the thread's own 8 positions, its partner's 8 in the other block
        const bool up_bits = (mine & d) == 0;
        for (; k >= E; k >>= 1) {
          const int* rk = cluster.map_shared_rank(sk, blockIdx.x ^ (k / E));
          const int* rv = cluster.map_shared_rank(sv, blockIdx.x ^ (k / E));
          const bool want_min = ((mine & k) == 0) == up_bits;
          int pk[kPerThread], pv[kPerThread];
          load8(rk + kPerThread * t, pk);
          load8(rv + kPerThread * t, pv);
          cluster.sync();  // every partner read before any write
#pragma unroll
          for (int r = 0; r < kPerThread; ++r) {
            if (takes(key[r], pk[r], want_min)) {
              key[r] = pk[r];
              val[r] = pv[r];
            }
          }
          store8(sk + kPerThread * t, key);
          store8(sv + kPerThread * t, val);
          cluster.sync();  // writes visible before the next reads
        }
      } else {
        __syncthreads();
      }
      for (; k >= 256; k >>= 1) {
        for (int p = t; p < E / 2; p += nt) {
          const int i = lower_index(p, k);
          const int j = i + k;
          const int ki = sk[i], kj = sk[j];
          if (((base + i) & d) == 0 ? kj < ki : kj > ki) {
            sk[i] = kj;
            sk[j] = ki;
            const int v = sv[i];
            sv[i] = sv[j];
            sv[j] = v;
          }
        }
        __syncthreads();
      }
      load8(sk + kPerThread * t, key);
      load8(sv + kPerThread * t, val);
    }
    // 8 <= k < 256: the partner of register r is register r of lane
    // ^ (k / 8); bit d of the index is the same for all 8 registers
    for (; k >= kPerThread; k >>= 1) {
      const int m = k / kPerThread;
      const bool want_min = ((t & m) == 0) == ((mine & d) == 0);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int pk = __shfl_xor_sync(0xffffffffu, key[r], m);
        const int pv = __shfl_xor_sync(0xffffffffu, val[r], m);
        if (takes(key[r], pk, want_min)) {
          key[r] = pk;
          val[r] = pv;
        }
      }
    }
    // k < 8: pairs of registers (r, r | k)
#pragma unroll
    for (int kk = kPerThread / 2; kk >= 1; kk >>= 1) {
      if (kk <= k) {
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
          if (r & kk) continue;
          const int q = r | kk;
          const bool asc = ((mine + r) & d) == 0;
          if (asc ? key[q] < key[r] : key[q] > key[r]) {
            const int tk = key[r];
            key[r] = key[q];
            key[q] = tk;
            const int tv = val[r];
            val[r] = val[q];
            val[q] = tv;
          }
        }
      }
    }
  }

  store8(sk + kPerThread * t, key);
  store8(sv + kPerThread * t, val);
  __syncthreads();
  for (int e = t; e < E; e += nt) {
    const int gi = base + e;
    if (gi < n) {
      out_k[gi] = sk[e];
      out_v[gi] = sv[e];
    }
  }
}

}  // namespace wst

// in_k, in_v: (n,) int32 on `device`; out_k, out_v: (n,) int32, the first n
// pairs of the sorted padded array. n_pad = max(1024, next power of two of
// n) <= 65,536. One launch on `stream`; returns its CUDA error (0 if none).
extern "C" int wst_bitonic_sort(const int* in_k, const int* in_v,
                                int* out_k, int* out_v, int n, int n_pad,
                                int device, void* stream) {
  if (n < 0 || n > n_pad || n_pad < wst::kMinPairs ||
      n_pad > wst::kMaxPairs || (n_pad & (n_pad - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (device < 0 || device >= wst::kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int E = n_pad < wst::kBlockPairs ? n_pad : wst::kBlockPairs;
  const int smem = 2 * E * static_cast<int>(sizeof(int));
  // The 64 KB opt-in belongs to the function on a device: set it on the
  // first launch there only.
  static std::atomic<bool> smem_set[wst::kMaxDevices];
  if (!smem_set[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(wst::bitonic_sort_cluster,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * wst::kBlockPairs * sizeof(int));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device].store(true, std::memory_order_release);
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_pad / E);
  cfg.blockDim = dim3(E / wst::kPerThread);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_pad / E;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wst::bitonic_sort_cluster, in_k, in_v,
                           out_k, out_v, n, n_pad);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
