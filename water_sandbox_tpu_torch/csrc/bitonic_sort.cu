// Ascending bitonic sort of int32 (key, value) pairs, in place.
//
// Replaces the TPU kernel water_sandbox_tpu/ops/pallas/bitonic_sort.py::
// _sort_kernel (launched by sort_pairs, used by argsort_keys). It runs the
// same network: d = 2 ... n_pad, k = d/2 ... 1, partner i ^ k, and element i
// takes its partner's pair iff it should hold the pair's minimum (its index
// and the d-block's direction agree) and the partner's key is strictly
// smaller, or the maximum and strictly larger. With strict comparisons on
// both sides equal keys never move, so a pair swaps as a whole or not at
// all: the compare-exchange below gives the TPU kernel's keys AND values bit
// for bit, ties included. The wrapper pads n to n_pad (a power of two,
// 1,024 ... 65,536) with INT32_MAX keys.
//
// Design. The TPU kernel holds all n_pad pairs in VMEM and runs every stage
// as lane and sublane rolls in one kernel. 65,536 pairs take 512 KB, more
// than one block's 227 KB of shared memory, and blocks cannot synchronise
// with each other. So the stages split by partner distance k:
//   * k < kTile (4,096 pairs, 32 KB of shared memory): one block loads its
//     tile, runs all consecutive such stages with __syncthreads() between,
//     and writes it back. The first launch sorts every tile (d = 2 ...
//     kTile); after each larger d, one launch runs its stages k < kTile.
//   * k >= kTile: one launch per stage, one thread per pair, straight from
//     device memory (each stage is a barrier across the whole array).
// At n_pad = 65,536 that is 15 launches instead of the network's 136 stages.
//
// What bounds it on the H100: launch latency and the global stages' memory
// traffic (512 KB read and written per global stage, all in L2); the tile
// stages are shared-memory bound with 2 pairs per thread per stage. Not done
// yet: register-level stages for k < 32 (warp shuffles), larger tiles in
// dynamic shared memory, and a cluster-wide (DSMEM) merge to fold the
// global stages into one launch.

#include <cuda_runtime.h>

namespace wst {

constexpr int kTile = 4096;
constexpr int kTileThreads = 1024;
constexpr int kGlobalThreads = 256;

// Index of the lower element of pair p at partner distance k: p with a 0
// bit inserted at bit position log2(k).
__device__ __forceinline__ int lower_index(int p, int k) {
  return ((p & ~(k - 1)) << 1) | (p & (k - 1));
}

// Pair (i, i + k), i with bit k clear; `ascending` is the direction of the
// d-block holding both.
__device__ __forceinline__ void compare_exchange(int* keys, int* vals, int i,
                                                 int k, bool ascending) {
  const int j = i + k;
  const int ki = keys[i];
  const int kj = keys[j];
  if (ascending ? (kj < ki) : (kj > ki)) {
    keys[i] = kj;
    keys[j] = ki;
    const int v = vals[i];
    vals[i] = vals[j];
    vals[j] = v;
  }
}

// One stage (d, k) with k >= the tile, over the whole array.
__global__ void __launch_bounds__(kGlobalThreads)
bitonic_global_stage(int* __restrict__ keys, int* __restrict__ vals,
                     int n_half, int k, int d) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_half) return;
  const int i = lower_index(p, k);
  compare_exchange(keys, vals, i, k, (i & d) == 0);
}

// Every stage with k < tile of the blocks d = d_first, 2 d_first, ...,
// d_last, on `tile`-element tiles in shared memory.
__global__ void __launch_bounds__(kTileThreads)
bitonic_tile_stages(int* __restrict__ keys, int* __restrict__ vals, int tile,
                    int d_first, int d_last) {
  __shared__ int sk[kTile];
  __shared__ int sv[kTile];
  const int base = blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sk[t] = keys[base + t];
    sv[t] = vals[base + t];
  }
  __syncthreads();
  for (int d = d_first; d <= d_last; d <<= 1) {
    for (int k = (d < tile ? d : tile) >> 1; k >= 1; k >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int i = lower_index(p, k);
        // the direction comes from the GLOBAL index
        compare_exchange(sk, sv, i, k, ((base + i) & d) == 0);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    keys[base + t] = sk[t];
    vals[base + t] = sv[t];
  }
}

}  // namespace wst

// keys, vals: (n_pad,) int32 on `device`, sorted in place by key; n_pad a
// power of two >= 2. Launches on `stream` and returns the first CUDA error
// (0 if none).
extern "C" int wst_bitonic_sort(int* keys, int* vals, int n_pad, int device,
                                void* stream) {
  if (n_pad < 2 || (n_pad & (n_pad - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = n_pad < wst::kTile ? n_pad : wst::kTile;
  const int blocks = n_pad / tile;
  const int n_half = n_pad / 2;
  const int gblocks = (n_half + wst::kGlobalThreads - 1) / wst::kGlobalThreads;

  wst::bitonic_tile_stages<<<blocks, wst::kTileThreads, 0, s>>>(
      keys, vals, tile, 2, tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int d = 2 * tile; d <= n_pad; d <<= 1) {
    for (int k = d >> 1; k >= tile; k >>= 1) {
      wst::bitonic_global_stage<<<gblocks, wst::kGlobalThreads, 0, s>>>(
          keys, vals, n_half, k, d);
      if ((err = cudaGetLastError()) != cudaSuccess) {
        return static_cast<int>(err);
      }
    }
    wst::bitonic_tile_stages<<<blocks, wst::kTileThreads, 0, s>>>(
        keys, vals, tile, d, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
