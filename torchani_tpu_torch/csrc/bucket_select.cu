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
// What bounds them on this card: bytes.  At the 10,002-atom water box
// (G = 343, C = 64, K = 104) 1.04 M lanes are occupied; each kernel moves
// their keys (4 bytes a lane), one (lanes, 3) f32 table (12 bytes a lane)
// and the (G, 27, C, 3) candidate table (7.1 MB): 23.8 MB, 7 us at
// 3.35 TB/s.  There is no arithmetic beyond the address (K2: three adds a
// lane).  On an H100 at 700 W the forward takes 9 us back to back (its data
// then stays in the L2) and 13 us between the refresh's other kernels, the
// backward 24 and 31 us: 343 blocks are 2.6 an SM, each thread walks its
// lanes through a dependent key -> shared memory chain, and the backward's
// atomics on one candidate serialize.
//
// Design:
// - one block per bucket; the bucket's 27 * C * 3 candidate tile lives in
//   shared memory (20.7 KB at C = 64, 83 KB at C = 256: dynamic shared
//   memory, raised above 48 KB with cudaFuncSetAttribute), so each
//   candidate is read from device memory once, coalesced, however many
//   lanes select it;
// - threads stride over the flat (lane, component) elements of the bucket's
//   occupied lanes, so the (lanes, 3) table is read or written fully
//   coalesced; the three threads of a lane read the same key;
// - the backward sums into the shared tile with atomicAdd (keys may repeat:
//   every slot row of a bucket can point at the same candidate), then
//   writes the tile out once.  The order of a sum therefore changes from
//   run to run; the forward has no sums and is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSections = 27;

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
bucket_select_fwd_kernel(const float* __restrict__ cand,   // (G, 27, C, 3)
                         const int* __restrict__ keys,     // (G, R)
                         const int* __restrict__ nlanes,   // (G,) or null
                         float* __restrict__ out,          // (G, R, 3)
                         int c, int r) {
  extern __shared__ float tile[];
  const int g = blockIdx.x;
  const int limit = lane_limit(nlanes, g, r);
  if (limit == 0) {
    return;  // block-uniform: an empty bucket writes nothing
  }
  const int tile_len = kSections * c * 3;
  const float* src = cand + static_cast<size_t>(g) * tile_len;
  for (int i = threadIdx.x; i < tile_len; i += kThreads) {
    tile[i] = src[i];
  }
  __syncthreads();

  const int* bucket_keys = keys + static_cast<size_t>(g) * r;
  float* dst = out + static_cast<size_t>(g) * r * 3;
  const int elems = limit * 3;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int lane = e / 3;
    const int d = e - lane * 3;
    const int slot = tile_slot(bucket_keys[lane], c);
    dst[e] = slot >= 0 ? tile[slot * 3 + d] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
bucket_select_bwd_kernel(const float* __restrict__ g_out,  // (G, R, 3)
                         const int* __restrict__ keys,     // (G, R)
                         const int* __restrict__ nlanes,   // (G,) or null
                         float* __restrict__ d_cand,       // (G, 27, C, 3)
                         int c, int r) {
  extern __shared__ float tile[];
  const int g = blockIdx.x;
  const int tile_len = kSections * c * 3;
  for (int i = threadIdx.x; i < tile_len; i += kThreads) {
    tile[i] = 0.0f;
  }
  __syncthreads();

  const int limit = lane_limit(nlanes, g, r);
  const int* bucket_keys = keys + static_cast<size_t>(g) * r;
  const float* src = g_out + static_cast<size_t>(g) * r * 3;
  const int elems = limit * 3;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int lane = e / 3;
    const int d = e - lane * 3;
    const int slot = tile_slot(bucket_keys[lane], c);
    if (slot >= 0) {
      atomicAdd(&tile[slot * 3 + d], src[e]);
    }
  }
  __syncthreads();

  float* dst = d_cand + static_cast<size_t>(g) * tile_len;
  for (int i = threadIdx.x; i < tile_len; i += kThreads) {
    dst[i] = tile[i];
  }
}

template <typename Kernel>
int launch(Kernel kernel, const float* src, const int* keys, const int* nlanes,
           float* dst, int g, int c, int r, int device, void* stream) {
  if (g <= 0 || c <= 0 || c > 256 || r < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(kSections) * c * 3 * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(src, keys, nlanes,
                                                                  dst, c, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both launch on `stream` (a cudaStream_t) of `device` and return the
// cudaError_t of the launch (0 on success).  All arrays are contiguous
// device arrays; `nlanes` may be null (every lane is then processed).

int bucket_select_fwd_launch(const float* cand, const int* keys, const int* nlanes,
                             float* out, int g, int c, int r, int device, void* stream) {
  return launch(bucket_select_fwd_kernel, cand, keys, nlanes, out, g, c, r, device, stream);
}

int bucket_select_bwd_launch(const float* g_out, const int* keys, const int* nlanes,
                             float* d_cand, int g, int c, int r, int device, void* stream) {
  return launch(bucket_select_bwd_kernel, g_out, keys, nlanes, d_cand, g, c, r, device,
                stream);
}

const char* bucket_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
