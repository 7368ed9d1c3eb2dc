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
// What bounds them on this card: bytes (keys 4 bytes a lane, values 4 P
// bytes a lane, the candidate table once); there is no arithmetic beyond the
// address (the backward: P adds a lane).
//
// Design:
// - one block per bucket; the bucket's 27 * C * P candidate tile lives in
//   dynamic shared memory (60 KB at C = 112, P = 5; 138 KB at C = 256,
//   P = 5), raised above 48 KB with cudaFuncSetAttribute.  A tile that does
//   not fit the card's 227 KB is refused with cudaErrorInvalidValue;
// - 1024 threads a block: at 5 x 5 x 5 buckets there are fewer blocks (125)
//   than multiprocessors (132), so a block must hide its own latency;
// - threads stride over the flat (lane, channel) elements of the bucket's
//   occupied lanes, so the (lanes, P) table is read or written coalesced;
// - the backward sums into the shared tile with atomicAdd (keys may repeat:
//   every slot row of a bucket can point at the same candidate), then writes
//   the tile out once.  The order of a sum changes from run to run; the
//   forward has no sums and is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSections = 27;
constexpr size_t kMaxSharedBytes = 227 * 1024;

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

__global__ void __launch_bounds__(kThreads)
vals_select_bwd_kernel(const float* __restrict__ g_out,  // (G, R, P)
                       const int* __restrict__ keys,     // (G, R)
                       const int* __restrict__ nlanes,   // (G,) or null
                       float* __restrict__ d_cand,       // (G, 27, C, P)
                       int c, int r, int p) {
  extern __shared__ float tile[];
  const int g = blockIdx.x;
  const int tile_len = kSections * c * p;
  for (int i = threadIdx.x; i < tile_len; i += kThreads) {
    tile[i] = 0.0f;
  }
  __syncthreads();

  const int limit = lane_limit(nlanes, g, r);
  const int* bucket_keys = keys + static_cast<size_t>(g) * r;
  const float* src = g_out + static_cast<size_t>(g) * r * p;
  const int elems = limit * p;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int lane = e / p;
    const int d = e - lane * p;
    const int slot = tile_slot(bucket_keys[lane], c);
    if (slot >= 0) {
      atomicAdd(&tile[slot * p + d], src[e]);
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

}  // namespace

extern "C" {

// Both launch on `stream` (a cudaStream_t) of `device` and return the
// cudaError_t of the launch (0 on success).  All arrays are contiguous
// device arrays; `nlanes` may be null (every lane is then processed).

int vals_select_fwd_launch(const float* cand, const int* keys, const int* nlanes,
                           float* out, int g, int c, int r, int p, int device,
                           void* stream) {
  return launch(vals_select_fwd_kernel, cand, keys, nlanes, out, g, c, r, p, device,
                stream);
}

int vals_select_bwd_launch(const float* g_out, const int* keys, const int* nlanes,
                           float* d_cand, int g, int c, int r, int p, int device,
                           void* stream) {
  return launch(vals_select_bwd_kernel, g_out, keys, nlanes, d_cand, g, c, r, p, device,
                stream);
}

const char* vals_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
