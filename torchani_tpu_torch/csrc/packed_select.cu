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
// written, zeros included.
//
// The TPU kernels walk a span's tiles in one grid step, pick the candidate
// plane by a dynamic index and select with one-hot products over a bf16
// triple split; none of that is carried over.
//
// Who owns what: ONE BLOCK OWNS ONE BUCKET and all the tiles that name it
// (`grid = (SB, n_spans)`).  The rows of a bucket may span several tiles, and
// in the backward they all add to the same candidate tile.  With one owner
// the sums stay in shared memory and d_cand is written once, with no global
// atomics and no memset before the launch; the forward reads each bucket's
// candidate tile from device memory once.  The price is that a block first
// scans its span's tile_bucket row (S_cap / 8 integers) for its tiles.  A
// bucket's tiles are consecutive in tables built by `pack_tables`, but the
// kernels do not rely on it: they visit the tiles between the first and the
// last match and skip the others.  A tile whose id is outside [0, SB) has no
// owner and is left unwritten.
//
// What bounds them on this card: bytes (keys 4 and values 12 bytes for each
// of the rows' KL lanes, the candidate table once).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSections = 27;
constexpr int kTileRows = 8;
constexpr size_t kMaxSharedBytes = 227 * 1024;

__device__ __forceinline__ int tile_slot(int key, int c) {
  const int sec = key >> 8;
  const int rank = key & 255;
  if (sec < 0 || sec >= kSections || rank >= c) {
    return -1;
  }
  return sec * c + rank;
}

// first and last tile of `span` that name local bucket `b` (first > last if
// none), the same in every thread of the block
__device__ __forceinline__ void owned_tiles(const int* span_tiles, int n_tiles, int b,
                                            int* first, int* last) {
  __shared__ int s_first, s_last;
  if (threadIdx.x == 0) {
    s_first = n_tiles;
    s_last = -1;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
    if (span_tiles[t] == b) {
      atomicMin(&s_first, t);
      atomicMax(&s_last, t);
    }
  }
  __syncthreads();
  *first = s_first;
  *last = s_last;
}

__global__ void __launch_bounds__(kThreads)
packed_select_fwd_kernel(const float* __restrict__ cand,        // (G, 27, C, 3)
                         const int* __restrict__ keys,          // (n_spans, S_cap * KL)
                         const int* __restrict__ tile_bucket,   // (n_spans, n_tiles)
                         float* __restrict__ out,               // (n_spans, S_cap * KL, 3)
                         int c, int n_tiles, int kl) {
  extern __shared__ float tile[];
  const int b = blockIdx.x;
  const int span = blockIdx.y;
  const int sb = gridDim.x;
  const int* span_tiles = tile_bucket + static_cast<size_t>(span) * n_tiles;
  int first, last;
  owned_tiles(span_tiles, n_tiles, b, &first, &last);
  if (first > last) {
    return;  // block-uniform: a bucket without rows writes nothing
  }
  const int tile_len = kSections * c * 3;
  const float* src = cand + (static_cast<size_t>(span) * sb + b) * tile_len;
  for (int i = threadIdx.x; i < tile_len; i += kThreads) {
    tile[i] = src[i];
  }
  __syncthreads();

  const int tile_lanes = kTileRows * kl;
  const size_t span_lanes = static_cast<size_t>(n_tiles) * tile_lanes;
  for (int t = first; t <= last; ++t) {
    if (span_tiles[t] != b) {
      continue;
    }
    const size_t base = static_cast<size_t>(span) * span_lanes + static_cast<size_t>(t) * tile_lanes;
    const int* tile_keys = keys + base;
    float* dst = out + base * 3;
    for (int e = threadIdx.x; e < tile_lanes * 3; e += kThreads) {
      const int lane = e / 3;
      const int d = e - lane * 3;
      const int slot = tile_slot(tile_keys[lane], c);
      dst[e] = slot >= 0 ? tile[slot * 3 + d] : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
packed_select_bwd_kernel(const float* __restrict__ g_out,       // (n_spans, S_cap * KL, 3)
                         const int* __restrict__ keys,          // (n_spans, S_cap * KL)
                         const int* __restrict__ tile_bucket,   // (n_spans, n_tiles)
                         float* __restrict__ d_cand,            // (G, 27, C, 3)
                         int c, int n_tiles, int kl) {
  extern __shared__ float tile[];
  const int b = blockIdx.x;
  const int span = blockIdx.y;
  const int sb = gridDim.x;
  const int* span_tiles = tile_bucket + static_cast<size_t>(span) * n_tiles;
  const int tile_len = kSections * c * 3;
  for (int i = threadIdx.x; i < tile_len; i += kThreads) {
    tile[i] = 0.0f;
  }
  int first, last;
  owned_tiles(span_tiles, n_tiles, b, &first, &last);  // syncs: the tile is zero

  const int tile_lanes = kTileRows * kl;
  const size_t span_lanes = static_cast<size_t>(n_tiles) * tile_lanes;
  for (int t = first; t <= last; ++t) {
    if (span_tiles[t] != b) {
      continue;
    }
    const size_t base = static_cast<size_t>(span) * span_lanes + static_cast<size_t>(t) * tile_lanes;
    const int* tile_keys = keys + base;
    const float* src = g_out + base * 3;
    for (int e = threadIdx.x; e < tile_lanes * 3; e += kThreads) {
      const int lane = e / 3;
      const int d = e - lane * 3;
      const int slot = tile_slot(tile_keys[lane], c);
      if (slot >= 0) {
        atomicAdd(&tile[slot * 3 + d], src[e]);
      }
    }
  }
  __syncthreads();

  float* dst = d_cand + (static_cast<size_t>(span) * sb + b) * tile_len;
  for (int i = threadIdx.x; i < tile_len; i += kThreads) {
    dst[i] = tile[i];
  }
}

template <typename Kernel>
int launch(Kernel kernel, const float* src, const int* keys, const int* tile_bucket,
           float* dst, int n_spans, int sb, int c, int n_tiles, int kl, int device,
           void* stream) {
  if (n_spans <= 0 || n_spans > 65535 || sb <= 0 || c <= 0 || c > 256 || n_tiles <= 0 ||
      kl <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kSections) * c * 3 * sizeof(float);
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
  const dim3 grid(sb, n_spans);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      src, keys, tile_bucket, dst, c, n_tiles, kl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both launch on `stream` (a cudaStream_t) of `device` and return the
// cudaError_t of the launch (0 on success).  All arrays are contiguous
// device arrays.

int packed_select_fwd_launch(const float* cand, const int* keys, const int* tile_bucket,
                             float* out, int n_spans, int sb, int c, int n_tiles, int kl,
                             int device, void* stream) {
  return launch(packed_select_fwd_kernel, cand, keys, tile_bucket, out, n_spans, sb, c,
                n_tiles, kl, device, stream);
}

int packed_select_bwd_launch(const float* g_out, const int* keys, const int* tile_bucket,
                             float* d_cand, int n_spans, int sb, int c, int n_tiles, int kl,
                             int device, void* stream) {
  return launch(packed_select_bwd_kernel, g_out, keys, tile_bucket, d_cand, n_spans, sb, c,
                n_tiles, kl, device, stream);
}

const char* packed_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
