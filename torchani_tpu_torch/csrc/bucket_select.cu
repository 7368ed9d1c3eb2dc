// Bucket-local lane selection and its transpose for Hopper (sm_90a): the
// per-step neighbor refresh of the MD loop.
//
// Replaces the Pallas TPU kernels `_fwd_kernel`/`_fwd_chunk` and
// `_bwd_kernel`/`_bwd_chunk` of torchani_tpu/bucket_refresh.py (:346-470),
// reached through `_bucket_select_fwd` (pallas_call at :504) and
// `_bucket_select_bwd` (pallas_call at :544), and their A/B variants in
// tools/bucketdot_v2_experiment.py (:102, :155).  Same contract, in the
// natural layout: with sec = key >> 8 and rank = key & 255,
//
//   forward   out[g, r, :] = cand[g, sec, rank, :]   if sec < 27, else 0
//   backward  d_cand[g, sec, rank, :] += g_out[g, r, :]   where sec < 27
//
// for cand, d_cand (G, 27, C, 3) f32, keys (G, R) int32 and out, g_out
// (G, R, 3) f32.  `nlanes` (G,) bounds each bucket's occupied lanes: lanes
// at or past nlanes[g] are all sentinels; the forward leaves them unwritten
// and the backward does not read them.  The backward writes every element
// of d_cand, zeros included, in every bucket.
//
// The TPU kernels select with one-hot matrix products over a bf16 triple
// split of the values, with sections padded to 32 rows and lanes chunked in
// 128s; none of that is carried over.  Here a selection is a copy of f32
// values, so it is exact for free.
//
// K1, the forward, is bound by bytes.  At the 10,002-atom water box
// (G = 343, C = 64, K = 104) 1.04 M lanes are occupied; each kernel moves
// their keys (4 bytes a lane), one (lanes, 3) f32 table (12 bytes a lane)
// and the (G, 27, C, 3) candidate table (7.1 MB): 23.8 MB, 7 us at
// 3.35 TB/s; at the ANI-2dr tables (G = 125, C = 96, K = 336, 3.36 M
// lanes) 57.7 MB, 17 us.  What held its first design (one block of 256
// threads a bucket) was latency, as for K2: timed apart on an H100
// (ablated copies, torch.profiler), its tile load took 2.5 us and its selection 56.6 of
// its 60 us at the ANI-2dr tables, 125 blocks of 8 warps each walking ~315
// elements a thread through a dependent key -> shared -> store chain.
// Reading the candidates from L2 in place of a shared tile was slower.
// Its design:
// - a bucket's occupied lanes are split over S independent blocks (grid
//   S * G; no cluster: a selection has no sum to reduce), each of which
//   loads the bucket's 27 * C * 3 candidate tile into shared memory (20.7
//   KB at C = 64, 31 KB at C = 96, 83 KB at C = 256: dynamic shared
//   memory, raised above 48 KB with cudaFuncSetAttribute), 16 bytes a load
//   where C is a multiple of 4;
// - the wrapper picks the block size and S by K2's rule (`_fwd_split`):
//   1,024 threads, or 512 where only that puts every bucket's block on the
//   card at once, and the largest S that keeps one wave: S = 2 of 1,024 at
//   the ANI-2dr tables, S = 1 of 512 at the ANI-2x ones;
// - threads stride over the flat (lane, component) elements of their
//   lanes, so the (lanes, 3) table is written coalesced.  Writing 4 lanes a
//   thread as three 16-byte stores was slower (a warp's store then spans 48
//   sectors a third written), and so was loading 2 to 8 keys ahead.
// It has no sums and is deterministic.
//
// K2, the backward, replaces `_bwd_kernel`/`_bwd_chunk`
// (torchani_tpu/bucket_refresh.py:406-470).  Its bound is bytes too (the
// same 23.8 MB at the ANI-2x tables; 57.7 MB, 17 us, at the ANI-2dr ones:
// G = 125, C = 96, K = 336, 3.36 M occupied lanes; three adds a lane are
// nothing beside them), but what held its first design (one block of 256
// threads per bucket, each thread walking its elements through a dependent
// key -> value -> shared-atomic chain) was latency: one element a thread
// cost the same ~0.66 us at both table sets, so the time went with the
// elements per thread, not with bytes.  At 125 buckets that was one block
// of 8 warps on 125 of the 132 SMs (64 warps fit), 315 elements a thread,
// 0.207 ms on an H100.
//
// K2's design, shared with K4b (vals_select.cu):
// - a bucket's occupied lanes are split over a thread-block cluster of S
//   blocks (S in 1, 2, 4, 8; grid S * G, cluster dims (S, 1, 1), launched
//   with cudaLaunchKernelEx); block q of the cluster takes lanes
//   [q L / S, (q + 1) L / S) of L = nlanes[g];
// - the wrapper picks the block size and S from G, the tile's bytes and
//   the card's SM count (`_cluster_split`): 1,024 threads, or 512 where
//   only that puts every bucket's block on the card at once, and the
//   largest S whose S * G blocks still all fit.  A block has a fixed
//   lifetime (its tile's zeros, two cluster barriers, the reduction), so
//   one wave of blocks beats more threads in two: S = 2 of 1,024 threads at
//   the ANI-2dr tables (250 blocks on 132 SMs), S = 1 of 512 at the ANI-2x
//   ones (343 blocks);
// - the block size is a template parameter, so strides are constants; at
//   most 32 registers a thread, so 2,048 threads fit an SM where the tile
//   allows;
// - threads walk the flat (lane, component) elements, 4 at a time: each
//   thread loads 4 keys and 4 cotangents into registers before it issues
//   any atomic, so 8 independent loads are in flight per thread;
// - each block sums its share into its own 27 * C * 3 tile in shared
//   memory with atomicAdd (keys repeat: every slot row of a bucket can
//   point at the same candidate; the order of a sum changes from run to
//   run).  The stride of 3 is odd, so the components of neighbouring
//   candidates do not share banks;
// - the S tiles are reduced through distributed shared memory: after a
//   cluster barrier, block q sums its 1/S slice of the tile over the S
//   blocks' shared memory, in rank order, and writes that slice of d_cand
//   once, coalesced; a second cluster barrier keeps every block's shared
//   memory alive until all have read it.  No global atomics, no zero fill,
//   one launch.  No block returns early: a bucket with no lanes, or a block
//   with none of them, still reaches both barriers and writes its zeros.
// A cluster the card cannot place is refused (cudaOccupancyMaxActiveClusters
// of 0), and the error goes back to the wrapper, which raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kSections = 27;
constexpr int kSentinelKey = kSections << 8;
// K2: threads a block (this or half of it, as the wrapper's SPLIT_THREADS
// says), elements each thread loads before its atomics, and the largest
// cluster (the portable maximum)
constexpr int kBwdThreads = 1024;
constexpr int kBwdUnroll = 4;
constexpr int kMaxSplit = 8;
// K1: threads a block (this or half of it, as the wrapper's SPLIT_THREADS
// says) and the largest split
constexpr int kFwdThreads = 1024;
constexpr int kMaxFwdSplit = 64;

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

// Copies a bucket's tile of `len` floats into shared memory, 16 bytes a load
// where `vec` (the tile starts on 16 bytes and len is a multiple of 4)
template <int kBlock>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int len, int vec,
                                          float* tile) {
  if (vec) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* tile4 = reinterpret_cast<float4*>(tile);
#pragma unroll 4
    for (int i = threadIdx.x; i < len / 4; i += kBlock) {
      tile4[i] = __ldg(src4 + i);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < len; i += kBlock) {
      tile[i] = __ldg(src + i);
    }
  }
}

// K1 over S blocks per bucket of kBlock threads.  Block `part` of bucket g
// takes lanes [first, last) of its L = nlanes[g] occupied lanes; it loads
// the bucket's tile into shared memory (16 bytes a load where `vec` says
// that the tile starts on 16 bytes), and its threads walk the flat
// (lane, component) elements of those lanes, so a warp's store covers 32
// consecutive floats.
template <int kBlock>
__global__ void __launch_bounds__(kBlock)
bucket_select_fwd_kernel(const float* __restrict__ cand,   // (G, 27, C, 3)
                         const int* __restrict__ keys,     // (G, R)
                         const int* __restrict__ nlanes,   // (G,) or null
                         float* __restrict__ out,          // (G, R, 3)
                         int c, int r, int split, int vec) {
  extern __shared__ float tile[];
  const int g = blockIdx.x / split;
  const int part = blockIdx.x - g * split;
  const int limit = lane_limit(nlanes, g, r);
  const int first = static_cast<int>(static_cast<long long>(part) * limit / split);
  const int last = static_cast<int>(static_cast<long long>(part + 1) * limit / split);
  if (first >= last) {
    return;  // block-uniform: no lanes here, nothing to write
  }
  load_tile<kBlock>(cand + static_cast<size_t>(g) * kSections * c * 3, kSections * c * 3, vec,
                    tile);
  __syncthreads();

  const int* bucket_keys = keys + static_cast<size_t>(g) * r;
  float* dst = out + static_cast<size_t>(g) * r * 3;
  for (int e = first * 3 + threadIdx.x; e < last * 3; e += kBlock) {
    const int slot = tile_slot(__ldg(bucket_keys + e / 3), c);
    dst[e] = slot >= 0 ? tile[slot * 3 + e % 3] : 0.0f;
  }
}

// kBlock threads a block, a compile-time stride (the loads then take
// immediate offsets)
template <int kBlock>
__global__ void __launch_bounds__(kBlock, 2048 / kBlock)
bucket_select_bwd_kernel(const float* __restrict__ g_out,  // (G, R, 3)
                         const int* __restrict__ keys,     // (G, R)
                         const int* __restrict__ nlanes,   // (G,) or null
                         float* __restrict__ d_cand,       // (G, 27, C, 3)
                         int c, int r) {
  extern __shared__ float tile[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int part = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.x / split;
  const int tile_len = kSections * c * 3;
  for (int i = threadIdx.x; i < tile_len; i += kBlock) {
    tile[i] = 0.0f;
  }
  __syncthreads();

  // this block's share of the bucket's occupied lanes
  const int limit = lane_limit(nlanes, g, r);
  const int first = static_cast<int>(static_cast<long long>(part) * limit / split);
  const int last = static_cast<int>(static_cast<long long>(part + 1) * limit / split);
  const int* bucket_keys = keys + static_cast<size_t>(g) * r;
  const float* src = g_out + static_cast<size_t>(g) * r * 3;
  const int end = last * 3;
  for (int e0 = first * 3 + threadIdx.x; e0 < end; e0 += kBwdUnroll * kBlock) {
    int key[kBwdUnroll];
    float val[kBwdUnroll];
#pragma unroll
    for (int j = 0; j < kBwdUnroll; ++j) {
      const int e = e0 + j * kBlock;
      key[j] = e < end ? bucket_keys[e / 3] : kSentinelKey;
      val[j] = e < end ? src[e] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBwdUnroll; ++j) {
      const int e = e0 + j * kBlock;
      const int slot = tile_slot(key[j], c);
      if (slot >= 0) {
        atomicAdd(&tile[slot * 3 + e % 3], val[j]);
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

// K1 over `split` blocks of `threads` per bucket
int launch_fwd(const float* cand, const int* keys, const int* nlanes, float* out, int g,
               int c, int r, int split, int threads, int device, void* stream) {
  if (g <= 0 || c <= 0 || c > 256 || r < 0 || split < 1 || split > kMaxFwdSplit ||
      (threads != kFwdThreads && threads != kFwdThreads / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(kSections) * c * 3 * sizeof(float);
  void (*kernel)(const float*, const int*, const int*, float*, int, int, int, int) =
      threads == kFwdThreads ? bucket_select_fwd_kernel<kFwdThreads>
                             : bucket_select_fwd_kernel<kFwdThreads / 2>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const int vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(cand) % 16 == 0;
  kernel<<<g * split, threads, smem, static_cast<cudaStream_t>(stream)>>>(cand, keys, nlanes,
                                                                          out, c, r, split, vec);
  return static_cast<int>(cudaGetLastError());
}

// K2 over clusters of `split` blocks of `threads` per bucket
int launch_bwd(const float* g_out, const int* keys, const int* nlanes, float* d_cand,
               int g, int c, int r, int split, int threads, int device, void* stream) {
  if (g <= 0 || c <= 0 || c > 256 || r < 0 || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) != 0 || (threads != kBwdThreads && threads != kBwdThreads / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(kSections) * c * 3 * sizeof(float);
  void (*kernel)(const float*, const int*, const int*, float*, int, int) =
      threads == kBwdThreads ? bucket_select_bwd_kernel<kBwdThreads>
                             : bucket_select_bwd_kernel<kBwdThreads / 2>;
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
  err = cudaLaunchKernelEx(&config, kernel, g_out, keys, nlanes, d_cand, c, r);
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
// The forward splits each bucket's lanes over `split` independent blocks
// (1 to 64) of `threads` (1024 or 512); the backward over a cluster of
// `split` blocks (1, 2, 4 or 8) of `threads` (1024 or 512).

int bucket_select_fwd_launch(const float* cand, const int* keys, const int* nlanes,
                             float* out, int g, int c, int r, int split, int threads,
                             int device, void* stream) {
  return launch_fwd(cand, keys, nlanes, out, g, c, r, split, threads, device, stream);
}

int bucket_select_bwd_launch(const float* g_out, const int* keys, const int* nlanes,
                             float* d_cand, int g, int c, int r, int split, int threads,
                             int device, void* stream) {
  return launch_bwd(g_out, keys, nlanes, d_cand, g, c, r, split, threads, device, stream);
}

const char* bucket_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
