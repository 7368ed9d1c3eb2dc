// Bucket-local per-lane selection of runtime per-atom VALUES with P channels,
// and its transpose, for Hopper (sm_90a): values[idx] per neighbor lane
// without a gather over atoms, for quantities that change every step (the D3
// dispersion's coordination numbers, or its 5 Gaussian factors per atom).
//
// Replaces the Pallas TPU kernels `_fwd_kernel_vals` and `_bwd_kernel_vals`
// of torchani_tpu/bucket_refresh.py (:572-644), reached through
// `_vals_select_fwd` (pallas_call at :660) and `_vals_select_bwd`
// (pallas_call at :686).  Same contract, in the natural layout: with
// sec = key >> 8 and rank = key & 255,
//
//   forward   out[g, r, :] = cand[g, sec, rank, :]   if sec < 27, else 0
//   backward  d_cand[g, sec, rank, :] += g_out[g, r, :]   where sec < 27
//
// for cand, d_cand (G, 27, C, P) f32, keys (G, R) int32 and out, g_out
// (G, R, P) f32.  Values carry no image shift.  `nlanes` (G,) bounds each
// bucket's occupied lanes: lanes at or past nlanes[g] are all sentinels; the
// forward leaves them unwritten and the backward does not read them.  The
// backward writes every element of d_cand, zeros included, in every bucket.
//
// This is the position selection of bucket_select.cu with P channels in
// place of 3.  The TPU kernels' bf16 triple split, one-hot products, 32-row
// section padding and chunk tables are devices of that hardware and are not
// carried over: a selection is a copy of f32 values and is exact.
//
// K4f, the forward, is bound by bytes (keys 4 bytes a lane, values 4 P
// bytes a lane, the candidate table once; no arithmetic beyond the
// address).  Its design: one block of 1,024 threads per bucket (at 5 x 5 x 5
// buckets there are fewer blocks, 125, than multiprocessors, 132, so a
// block must hide its own latency); the bucket's 27 * C * P candidate tile
// lives in dynamic shared memory (52 KB at C = 96, P = 5; 138 KB at
// C = 256, P = 5), raised above 48 KB with cudaFuncSetAttribute; threads
// stride over the flat (lane, channel) elements of the bucket's occupied
// lanes, so the (lanes, P) table is written coalesced.  It has no sums and
// is deterministic.  A tile that does not fit the card's 227 KB is refused
// with cudaErrorInvalidValue, by both kernels.
//
// K4b, the backward, replaces `_bwd_kernel_vals`
// (torchani_tpu/bucket_refresh.py:608).  Its bound is bytes too (P adds a
// lane are nothing beside them): at the ANI-2dr tables (G = 125, C = 96,
// K = 336, 26,885 occupied lanes a bucket) 87 MB at P = 5, 26 us at
// 3.35 TB/s.  What held its first design (one block of 1,024 threads per
// bucket, each thread walking its elements through a dependent key ->
// value -> shared-atomic chain) was latency: one element a thread cost
// ~0.68 us, as it did in K2, so at P = 5 the 131 elements a thread of a
// block took 0.089 ms on an H100.
//
// K4b's design is K2's (bucket_select.cu), with P channels:
// - a bucket's occupied lanes are split over a thread-block cluster of S
//   blocks (S in 1, 2, 4, 8; grid S * G, cluster dims (S, 1, 1), launched
//   with cudaLaunchKernelEx); block q takes lanes [q L / S, (q + 1) L / S)
//   of L = nlanes[g].  The wrapper picks the block size (1,024 threads, or
//   512 where only that puts every bucket's block on the card at once) and
//   S (the largest whose blocks still all fit) from G, the tile's bytes and
//   the card's SM count (`_cluster_split`): S = 2 of 1,024 threads at the
//   ANI-2dr tables;
// - the channel count is a template parameter for D3's P = 5 and P = 1, so
//   that a flat element's lane and channel come from a multiplication, not
//   from an integer division by a run-time P (that division cost more than
//   the split gained); other P read it at run time;
// - the block size is a template parameter too (constant strides); at most
//   32 registers a thread, so two blocks of 1,024 threads fit an SM where
//   the tile allows (up to 113 KB each);
// - threads walk the flat (lane, channel) elements, 4 at a time: 4 keys and
//   4 cotangents are loaded into registers before any atomic is issued;
// - each block sums its share into its own 27 * C * P tile in shared memory
//   with atomicAdd, in an order that changes from run to run (D3's strides,
//   P = 5 and 1, are odd: neighbouring candidates do not share banks);
// - after a cluster barrier, block q sums its 1/S slice of the tile over
//   the S blocks' shared memory (distributed shared memory), in rank order,
//   writes that slice of d_cand once, coalesced, and waits at a second
//   cluster barrier so that no block's shared memory goes while another
//   reads it.  No global atomics, no zero fill, one launch; no block
//   returns early, so an empty bucket, or a block with no lanes, writes its
//   zeros.
// A cluster the card cannot place is refused (cudaOccupancyMaxActiveClusters
// of 0), and the error goes back to the wrapper, which raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kSections = 27;
constexpr int kSentinelKey = kSections << 8;
constexpr size_t kMaxSharedBytes = 227 * 1024;
// K4b: elements each thread loads before its atomics, and the largest
// cluster (the portable maximum); it launches kThreads or kThreads / 2 a
// block, as the wrapper's SPLIT_THREADS says
constexpr int kBwdUnroll = 4;
constexpr int kMaxSplit = 8;

__device__ __forceinline__ int lane_limit(const int* nlanes, int g, int r) {
  if (nlanes == nullptr) {
    return r;
  }
  return min(max(nlanes[g], 0), r);
}

// position of a key's candidate in the bucket's (27, C) tile, or -1 for the
// sentinel section (and for a rank the tile does not have)
__device__ __forceinline__ int tile_slot(int key, int c) {
  const int sec = key >> 8;
  const int rank = key & 255;
  if (sec < 0 || sec >= kSections || rank >= c) {
    return -1;
  }
  return sec * c + rank;
}

__global__ void __launch_bounds__(kThreads)
vals_select_fwd_kernel(const float* __restrict__ cand,   // (G, 27, C, P)
                       const int* __restrict__ keys,     // (G, R)
                       const int* __restrict__ nlanes,   // (G,) or null
                       float* __restrict__ out,          // (G, R, P)
                       int c, int r, int p) {
  extern __shared__ float tile[];
  const int g = blockIdx.x;
  const int limit = lane_limit(nlanes, g, r);
  if (limit == 0) {
    return;  // block-uniform: an empty bucket writes nothing
  }
  const int tile_len = kSections * c * p;
  const float* src = cand + static_cast<size_t>(g) * tile_len;
  for (int i = threadIdx.x; i < tile_len; i += kThreads) {
    tile[i] = src[i];
  }
  __syncthreads();

  const int* bucket_keys = keys + static_cast<size_t>(g) * r;
  float* dst = out + static_cast<size_t>(g) * r * p;
  const int elems = limit * p;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int lane = e / p;
    const int d = e - lane * p;
    const int slot = tile_slot(bucket_keys[lane], c);
    dst[e] = slot >= 0 ? tile[slot * p + d] : 0.0f;
  }
}

// kP > 0 fixes the channel count at compile time (the divisions by P are
// then multiplications); kP = 0 reads it from `p_any`.  kBlock threads a
// block, a compile-time stride
template <int kP, int kBlock>
__global__ void __launch_bounds__(kBlock, 2048 / kBlock)
vals_select_bwd_kernel(const float* __restrict__ g_out,  // (G, R, P)
                       const int* __restrict__ keys,     // (G, R)
                       const int* __restrict__ nlanes,   // (G,) or null
                       float* __restrict__ d_cand,       // (G, 27, C, P)
                       int c, int r, int p_any) {
  const int p = kP > 0 ? kP : p_any;
  extern __shared__ float tile[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int part = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.x / split;
  const int tile_len = kSections * c * p;
  for (int i = threadIdx.x; i < tile_len; i += kBlock) {
    tile[i] = 0.0f;
  }
  __syncthreads();

  // this block's share of the bucket's occupied lanes
  const int limit = lane_limit(nlanes, g, r);
  const int first = static_cast<int>(static_cast<long long>(part) * limit / split);
  const int last = static_cast<int>(static_cast<long long>(part + 1) * limit / split);
  const int* bucket_keys = keys + static_cast<size_t>(g) * r;
  const float* src = g_out + static_cast<size_t>(g) * r * p;
  const int end = last * p;
  for (int e0 = first * p + threadIdx.x; e0 < end; e0 += kBwdUnroll * kBlock) {
    int key[kBwdUnroll];
    float val[kBwdUnroll];
#pragma unroll
    for (int j = 0; j < kBwdUnroll; ++j) {
      const int e = e0 + j * kBlock;
      key[j] = e < end ? bucket_keys[e / p] : kSentinelKey;
      val[j] = e < end ? src[e] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBwdUnroll; ++j) {
      const int e = e0 + j * kBlock;
      const int slot = tile_slot(key[j], c);
      if (slot >= 0) {
        atomicAdd(&tile[slot * p + e % p], val[j]);
      }
    }
  }
  cluster.sync();  // every block's tile holds its share

  // block `part` sums its slice (a multiple of 32 floats) over the cluster
  const int share = ((tile_len + split - 1) / split + 31) / 32 * 32;
  const int lo = min(part * share, tile_len);
  const int hi = min(lo + share, tile_len);
  float* dst = d_cand + static_cast<size_t>(g) * tile_len;
  for (int i = lo + threadIdx.x; i < hi; i += kBlock) {
    float sum = 0.0f;
    for (int q = 0; q < split; ++q) {
      sum += cluster.map_shared_rank(tile, q)[i];
    }
    dst[i] = sum;
  }
  cluster.sync();  // no block leaves while another reads its tile
}

template <typename Kernel>
int launch(Kernel kernel, const float* src, const int* keys, const int* nlanes,
           float* dst, int g, int c, int r, int p, int device, void* stream) {
  if (g <= 0 || c <= 0 || c > 256 || r < 0 || p <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kSections) * c * p * sizeof(float);
  if (smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(src, keys, nlanes,
                                                                  dst, c, r, p);
  return static_cast<int>(cudaGetLastError());
}

using BwdKernel = void (*)(const float*, const int*, const int*, float*, int, int, int);

// D3's channel counts (5 by default, 1 with the frozen pair window) are
// compiled in; any other P takes the kernel that reads it at run time
template <int kBlock>
BwdKernel bwd_kernel(int p) {
  return p == 5   ? vals_select_bwd_kernel<5, kBlock>
         : p == 1 ? vals_select_bwd_kernel<1, kBlock>
                  : vals_select_bwd_kernel<0, kBlock>;
}

// K4b over clusters of `split` blocks of `threads` per bucket
int launch_bwd(const float* g_out, const int* keys, const int* nlanes, float* d_cand,
               int g, int c, int r, int p, int split, int threads, int device,
               void* stream) {
  if (g <= 0 || c <= 0 || c > 256 || r < 0 || p <= 0 || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) != 0 || (threads != kThreads && threads != kThreads / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kSections) * c * p * sizeof(float);
  if (smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const BwdKernel kernel =
      threads == kThreads ? bwd_kernel<kThreads>(p) : bwd_kernel<kThreads / 2>(p);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  cudaLaunchAttribute cluster_dims = {};
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = static_cast<unsigned>(split);
  cluster_dims.val.clusterDim.y = 1;
  cluster_dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(g * split));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster_dims;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (clusters == 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);  // no SM group fits one
  }
  err = cudaLaunchKernelEx(&config, kernel, g_out, keys, nlanes, d_cand, c, r, p);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both launch on `stream` (a cudaStream_t) of `device` and return the
// cudaError_t of the launch (0 on success).  All arrays are contiguous
// device arrays; `nlanes` may be null (every lane is then processed).
// The backward splits each bucket over a cluster of `split` blocks (1, 2,
// 4 or 8) of `threads` (1024 or 512).

int vals_select_fwd_launch(const float* cand, const int* keys, const int* nlanes,
                           float* out, int g, int c, int r, int p, int device,
                           void* stream) {
  return launch(vals_select_fwd_kernel, cand, keys, nlanes, out, g, c, r, p, device,
                stream);
}

int vals_select_bwd_launch(const float* g_out, const int* keys, const int* nlanes,
                           float* d_cand, int g, int c, int r, int p, int split, int threads,
                           int device, void* stream) {
  return launch_bwd(g_out, keys, nlanes, d_cand, g, c, r, p, split, threads, device, stream);
}

const char* vals_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
