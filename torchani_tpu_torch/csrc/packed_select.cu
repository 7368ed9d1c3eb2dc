// Atom-packed lane selection and its transpose for Hopper (sm_90a): the MD
// loop's per-step neighbor refresh over ATOM rows sorted by bucket, instead
// of the (bucket, slot) rows of bucket_select.cu.
//
// Replaces the Pallas TPU kernels `_pfwd_kernel` and `_pbwd_kernel` of
// torchani_tpu/bucket_refresh_packed.py (:215-276), reached through
// `_packed_select_fwd` (pallas_call at :290) and `_packed_select_bwd`
// (pallas_call at :316).  Same tables, natural value layouts.  Rows are
// grouped in spans of S_cap rows, a span covers SB = G / n_spans consecutive
// buckets, rows come in tiles of 8 that never straddle buckets, and
// tile_bucket[span, t] names the tile's bucket within its span.  With
// b = span * SB + tile_bucket[span, row / 8], sec = key >> 8 and
// rank = key & 255,
//
//   forward   out[span, row, lane, :] = cand[b, sec, rank, :]  if sec < 27, else 0
//   backward  d_cand[b, sec, rank, :] += g_out[span, row, lane, :]  where sec < 27
//
// for cand, d_cand (G, 27, C, 3) f32, keys (n_spans, S_cap * KL) int32,
// tile_bucket (n_spans, S_cap / 8) int32 and out, g_out
// (n_spans, S_cap * KL, 3) f32.  Every element of out and of d_cand is
// written, zeros included.  A tile whose id is outside [0, SB) has no owner
// and is left unwritten.  A bucket may own runs of tiles that are not
// consecutive.  C is at most 256 and KL a multiple of 16, so that a tile's
// 8 * KL lanes are whole chunks of 128.
//
// The TPU kernels walk a span's tiles in one grid step, pick the candidate
// plane by a dynamic index and select with one-hot products over a bf16
// triple split; none of that is carried over.
//
// What bounds them on this card.  At the ANI-2dr water box (10,002 atoms;
// 125 spans of one bucket, S_cap = 104 rows, KL = 384, C = 96) the forward
// must read every lane's key (20 MB) and write every lane's position (60
// MB): 83.8 MB, 25 us at 3.35 TB/s.  The backward must read the keys, only
// the cotangents of the lanes that hold a neighbor (54% of them, always a
// prefix of the row) and write d_cand: 56.4 MB, 17 us.  Bytes are reached
// only with many loads in flight: a thread that walks its elements through
// one dependent 4-byte key load at a time is held by latency at twice the
// time (timed on an H100 80GB HBM3 at 700 W: keys made from the lane's bits
// in place of such loads halved a forward).  The backward's shared-memory
// atomics are compare-and-swap loops (ATOMS.CAST.SPIN: the card has no
// shared f32 add, and red.shared.add.f32 compiles to the same loop); in
// timed variants they took about a third of its time (plain stores in
// their place).
//
// The design, for both kernels:
// - a bucket's tiles are split over S blocks of 1,024 or 512 threads (grid
//   (SB * S, n_spans)), S and the block size from the wrapper
//   (`bucket_refresh._packed_split`, on K1's and K2's one-wave rule
//   `_one_wave`): every block is resident at once.  S = 2 of 1,024 at the
//   water box's tables.  The owned tiles' lanes are cut into chunks of 128;
//   block q of a bucket takes the chunks [q n / S, (q + 1) n / S) of its n,
//   and its warps take those chunks in turn, walking the span's tile_bucket
//   row to find each chunk's tile, so a bucket's tiles need not be
//   consecutive;
// - a thread takes 4 consecutive lanes of a chunk: its keys are one 16-byte
//   load, and a warp's key load is 512 contiguous bytes.  No division in
//   the loop but one per chunk for the tile walk;
// - at most 32 registers a thread, so two blocks of 1,024 fit an SM.
//
// K5f, the forward: S independent blocks, each of which loads the bucket's
// 27 * C * 3 candidate tile into shared memory (31 KB at C = 96, 83 KB at
// C = 256; 16 bytes a load where C is a multiple of 4).  Each warp loads the
// next chunk's keys before it works on the current one.  A chunk of
// sentinels only is written as zeros without touching the tile.  Otherwise
// the warp turns its keys into tile offsets in a 512-byte buffer of its own
// (16 KB a block of 1,024), so that thread t can write the chunk's float4s
// t, t + 32 and t + 64: three coalesced 16-byte stores a thread, each
// warp's store 512 contiguous bytes.  It has no sums and is deterministic.
//
// K5b, the backward: the S blocks of a bucket form a thread-block cluster
// (cluster dims (S, 1, 1), S in 1, 2, 4, 8; launched with
// cudaLaunchKernelEx).  Each block zeroes its own tile in shared memory; a
// thread whose 4 lanes are all sentinels reads nothing more, else it loads
// its 12 cotangents (three 16-byte loads) and adds them into the tile with
// atomicAdd (keys repeat: every row of a bucket can point at the same
// candidate; a row's lanes name distinct candidates, so one warp's atomics
// never collide with each other; the order of a sum changes from run to
// run).  The S tiles are then reduced through distributed shared memory:
// after a cluster barrier, block q sums its 1/S slice of the tile over the
// S blocks in rank order and writes that slice of d_cand once, coalesced; a
// second cluster barrier keeps every block's shared memory alive until all
// have read it.  No global atomics, no zero fill, one launch.  No block
// returns early: a bucket with no tiles still reaches both barriers and
// writes its zeros.  A cluster the card cannot place is refused
// (cudaOccupancyMaxActiveClusters of 0), and the error goes back to the
// wrapper, which raises.
//
// Chosen from timed variants on the same card: more blocks than one wave
// (S = 4) was slower for both; for the backward, coalesced cotangent loads
// through a per-warp buffer of tile offsets, and loading the next chunk's
// keys ahead, were slower than the thread's own three loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kSections = 27;
constexpr int kTileRows = 8;
// lanes a warp takes at a time: 4 a thread
constexpr int kChunk = 128;
// threads a block (this or half of it, as the wrapper's SPLIT_THREADS says)
// and the largest split (the portable cluster maximum)
constexpr int kThreads = 1024;
constexpr int kMaxSplit = 8;
constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// offset of a key's candidate in the bucket's (27, C, 3) tile, or -1 for the
// sentinel section (and for a rank the tile does not have)
__device__ __forceinline__ int tile_offset(int key, int c) {
  const int sec = key >> 8;
  const int rank = key & 255;
  return (sec >= 0 && sec < kSections && rank < c) ? (sec * c + rank) * 3 : -1;
}

__host__ __device__ __forceinline__ int tile_len(int c) { return kSections * c * 3; }

// the tile's floats rounded up to 16 bytes: K5f's offset buffers follow it
__host__ __device__ __forceinline__ int padded_tile_len(int c) {
  return (tile_len(c) + 3) / 4 * 4;
}

// first tile of `span` that names local bucket `b` and how many do, the same
// in every thread of the block
struct Owned {
  int first;
  int count;
};

__device__ __forceinline__ Owned owned_tiles(const int* span_tiles, int n_tiles, int b) {
  __shared__ int s_first, s_count;
  if (threadIdx.x == 0) {
    s_first = n_tiles;
    s_count = 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    if (span_tiles[t] == b) {
      atomicMin(&s_first, t);
      atomicAdd(&s_count, 1);
    }
  }
  __syncthreads();
  return {s_first, s_count};
}

// This block's chunks [lo, hi) of the `count` owned tiles' `count * cpt`
// chunks, split `split` ways
struct Share {
  int lo;
  int hi;
};

__device__ __forceinline__ Share block_share(int count, int cpt, int part, int split) {
  const long long total = static_cast<long long>(count) * cpt;
  return {static_cast<int>(part * total / split), static_cast<int>((part + 1) * total / split)};
}

// Walks one warp's increasing chunk numbers to the first lane of each chunk
// in the span: chunk q lies in the owned tile of ordinal q / cpt
struct TileWalk {
  const int* span_tiles;
  int b;
  int cpt;  // chunks a tile
  int t;    // current tile of the span ...
  int k;    // ... and its ordinal among the owned tiles

  __device__ __forceinline__ size_t first_lane(int q) {
    const int kq = q / cpt;
    while (k < kq) {
      ++t;
      k += span_tiles[t] == b;
    }
    return (static_cast<size_t>(t) * cpt + (q - kq * cpt)) * kChunk;
  }
};

// the 4 keys of this thread's lanes of the chunk at `lane0`
__device__ __forceinline__ int4 chunk_keys(const int* keys, size_t lane0) {
  return __ldg(reinterpret_cast<const int4*>(keys + lane0) + (threadIdx.x & 31));
}

// Copies a bucket's tile of `len` floats into shared memory, 16 bytes a load
// where `vec` (the tile starts on 16 bytes and len is a multiple of 4)
template <int kBlock>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int len, int vec,
                                          float* tile) {
  if (vec) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* tile4 = reinterpret_cast<float4*>(tile);
    for (int i = threadIdx.x; i < len / 4; i += kBlock) {
      tile4[i] = __ldg(src4 + i);
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kBlock) {
      tile[i] = __ldg(src + i);
    }
  }
}

template <int kBlock>
__global__ void __launch_bounds__(kBlock, 2048 / kBlock)
packed_select_fwd_kernel(const float* __restrict__ cand,        // (G, 27, C, 3)
                         const int* __restrict__ keys,          // (n_spans, S_cap * KL)
                         const int* __restrict__ tile_bucket,   // (n_spans, n_tiles)
                         float* __restrict__ out,               // (n_spans, S_cap * KL, 3)
                         int c, int n_tiles, int kl, int split, int vec) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int kWarps = kBlock / 32;
  const int sb = gridDim.x / split;
  const int b = blockIdx.x / split;
  const int span = blockIdx.y;
  const int* span_tiles = tile_bucket + static_cast<size_t>(span) * n_tiles;
  const Owned own = owned_tiles(span_tiles, n_tiles, b);
  const int cpt = kTileRows * kl / kChunk;
  const Share share = block_share(own.count, cpt, blockIdx.x - b * split, split);
  if (share.lo >= share.hi) {
    return;  // block-uniform: no chunks here, nothing to write
  }
  load_tile<kBlock>(cand + (static_cast<size_t>(span) * sb + b) * tile_len(c), tile_len(c), vec,
                    tile);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  int q = share.lo + warp;
  if (q >= share.hi) {
    return;
  }
  int* offsets = reinterpret_cast<int*>(tile + padded_tile_len(c)) + warp * kChunk;
  const size_t span_lane0 = static_cast<size_t>(span) * n_tiles * kTileRows * kl;
  const int* span_keys = keys + span_lane0;
  float* span_out = out + span_lane0 * 3;
  TileWalk walk{span_tiles, b, cpt, own.first, 0};
  size_t lane0 = walk.first_lane(q);
  int4 key = chunk_keys(span_keys, lane0);
  while (true) {
    // the next chunk's keys are in flight while this one is written
    const int q_next = q + kWarps;
    size_t lane0_next = 0;
    int4 key_next = key;
    if (q_next < share.hi) {
      lane0_next = walk.first_lane(q_next);
      key_next = chunk_keys(span_keys, lane0_next);
    }
    const int4 off = make_int4(tile_offset(key.x, c), tile_offset(key.y, c),
                               tile_offset(key.z, c), tile_offset(key.w, c));
    float4* dst = reinterpret_cast<float4*>(span_out + lane0 * 3) + lid;
    if (__all_sync(kFullMask, (off.x & off.y & off.z & off.w) < 0)) {
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dst[0] = zero;
      dst[32] = zero;
      dst[64] = zero;
    } else {
      reinterpret_cast<int4*>(offsets)[lid] = off;
      __syncwarp();
      // float4 j of this thread holds floats f0 .. f0 + 3 of the chunk: the
      // components d0 .. 2 of lane l0, then the first of lane l0 + 1
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int f0 = kChunk * j + 4 * lid;
        const int l0 = f0 / 3;
        const int d0 = f0 - 3 * l0;
        const int here = offsets[l0];
        const int next = offsets[l0 + 1];
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = d0 + i;
          const int o = d < 3 ? here : next;
          v[i] = o >= 0 ? tile[o + (d < 3 ? d : d - 3)] : 0.0f;
        }
        dst[32 * j] = make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncwarp();  // the buffer is read before the next chunk overwrites it
    }
    if (q_next >= share.hi) {
      break;
    }
    q = q_next;
    lane0 = lane0_next;
    key = key_next;
  }
}

template <int kBlock>
__global__ void __launch_bounds__(kBlock, 2048 / kBlock)
packed_select_bwd_kernel(const float* __restrict__ g_out,       // (n_spans, S_cap * KL, 3)
                         const int* __restrict__ keys,          // (n_spans, S_cap * KL)
                         const int* __restrict__ tile_bucket,   // (n_spans, n_tiles)
                         float* __restrict__ d_cand,            // (G, 27, C, 3)
                         int c, int n_tiles, int kl) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int kWarps = kBlock / 32;
  const cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int part = static_cast<int>(cluster.block_rank());
  const int sb = gridDim.x / split;
  const int b = blockIdx.x / split;
  const int span = blockIdx.y;
  const int* span_tiles = tile_bucket + static_cast<size_t>(span) * n_tiles;
  const int len = tile_len(c);
  for (int i = threadIdx.x; i < len; i += kBlock) {
    tile[i] = 0.0f;
  }
  const Owned own = owned_tiles(span_tiles, n_tiles, b);  // syncs: the tile is zero
  const int cpt = kTileRows * kl / kChunk;
  const Share share = block_share(own.count, cpt, part, split);

  const int lid = threadIdx.x & 31;
  const size_t span_lane0 = static_cast<size_t>(span) * n_tiles * kTileRows * kl;
  const int* span_keys = keys + span_lane0;
  const float* span_g = g_out + span_lane0 * 3;
  TileWalk walk{span_tiles, b, cpt, own.first, 0};
  for (int q = share.lo + (threadIdx.x >> 5); q < share.hi; q += kWarps) {
    const size_t lane0 = walk.first_lane(q);
    const int4 key = chunk_keys(span_keys, lane0);
    const int off[4] = {tile_offset(key.x, c), tile_offset(key.y, c), tile_offset(key.z, c),
                        tile_offset(key.w, c)};
    if ((off[0] & off[1] & off[2] & off[3]) < 0) {
      continue;  // four sentinels: their cotangents are not read
    }
    const float4* src = reinterpret_cast<const float4*>(span_g + lane0 * 3) + 3 * lid;
    const float4 g0 = __ldg(src);
    const float4 g1 = __ldg(src + 1);
    const float4 g2 = __ldg(src + 2);
    const float g[12] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w, g2.x, g2.y, g2.z, g2.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (off[i] >= 0) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          atomicAdd(tile + off[i] + d, g[3 * i + d]);
        }
      }
    }
  }
  cluster.sync();  // every block's tile holds its share

  // block `part` sums its slice (a multiple of 32 floats) over the cluster
  const int slice = ((len + split - 1) / split + 31) / 32 * 32;
  const int lo = min(part * slice, len);
  const int hi = min(lo + slice, len);
  float* dst = d_cand + (static_cast<size_t>(span) * sb + b) * len;
  for (int i = lo + threadIdx.x; i < hi; i += kBlock) {
    float sum = 0.0f;
    for (int r = 0; r < split; ++r) {
      sum += cluster.map_shared_rank(tile, r)[i];
    }
    dst[i] = sum;
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// the shared memory of a block: its tile, and for the forward one offset
// buffer of kChunk ints a warp
size_t shared_bytes(int c, int threads, bool forward) {
  const size_t buffers = forward ? static_cast<size_t>(threads / 32) * kChunk * sizeof(int) : 0;
  return static_cast<size_t>(padded_tile_len(c)) * sizeof(float) + buffers;
}

int check_args(int n_spans, int sb, int c, int n_tiles, int kl, int split, int threads) {
  if (n_spans <= 0 || n_spans > 65535 || sb <= 0 || c <= 0 || c > 256 || n_tiles <= 0 ||
      kl <= 0 || kl % 16 != 0 || split < 1 || split > kMaxSplit || (split & (split - 1)) != 0 ||
      (threads != kThreads && threads != kThreads / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem, int device) {
  if (smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  return static_cast<int>(err);
}

int launch_fwd(const float* cand, const int* keys, const int* tile_bucket, float* out,
               int n_spans, int sb, int c, int n_tiles, int kl, int split, int threads,
               int device, void* stream) {
  int rc = check_args(n_spans, sb, c, n_tiles, kl, split, threads);
  if (rc != 0) {
    return rc;
  }
  void (*kernel)(const float*, const int*, const int*, float*, int, int, int, int, int) =
      threads == kThreads ? packed_select_fwd_kernel<kThreads>
                          : packed_select_fwd_kernel<kThreads / 2>;
  const size_t smem = shared_bytes(c, threads, true);
  if ((rc = prepare(kernel, smem, device)) != 0) {
    return rc;
  }
  const int vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(cand) % 16 == 0;
  kernel<<<dim3(sb * split, n_spans), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cand, keys, tile_bucket, out, c, n_tiles, kl, split, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const float* g_out, const int* keys, const int* tile_bucket, float* d_cand,
               int n_spans, int sb, int c, int n_tiles, int kl, int split, int threads,
               int device, void* stream) {
  int rc = check_args(n_spans, sb, c, n_tiles, kl, split, threads);
  if (rc != 0) {
    return rc;
  }
  void (*kernel)(const float*, const int*, const int*, float*, int, int, int) =
      threads == kThreads ? packed_select_bwd_kernel<kThreads>
                          : packed_select_bwd_kernel<kThreads / 2>;
  const size_t smem = shared_bytes(c, threads, false);
  if ((rc = prepare(kernel, smem, device)) != 0) {
    return rc;
  }
  cudaLaunchAttribute cluster_dims = {};
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = static_cast<unsigned>(split);
  cluster_dims.val.clusterDim.y = 1;
  cluster_dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(sb * split), static_cast<unsigned>(n_spans));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster_dims;
  config.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (clusters == 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);  // no SM group fits one
  }
  err = cudaLaunchKernelEx(&config, kernel, g_out, keys, tile_bucket, d_cand, c, n_tiles, kl);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both launch on `stream` (a cudaStream_t) of `device` and return the
// cudaError_t of the launch (0 on success).  All arrays are contiguous
// device arrays.  Each bucket's tiles are split over `split` blocks (1, 2, 4
// or 8; a cluster in the backward) of `threads` (1024 or 512).

int packed_select_fwd_launch(const float* cand, const int* keys, const int* tile_bucket,
                             float* out, int n_spans, int sb, int c, int n_tiles, int kl,
                             int split, int threads, int device, void* stream) {
  return launch_fwd(cand, keys, tile_bucket, out, n_spans, sb, c, n_tiles, kl, split, threads,
                    device, stream);
}

int packed_select_bwd_launch(const float* g_out, const int* keys, const int* tile_bucket,
                             float* d_cand, int n_spans, int sb, int c, int n_tiles, int kl,
                             int split, int threads, int device, void* stream) {
  return launch_bwd(g_out, keys, tile_bucket, d_cand, n_spans, sb, c, n_tiles, kl, split,
                    threads, device, stream);
}

const char* packed_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
