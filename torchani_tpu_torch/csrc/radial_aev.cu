// Radial AEV (K6), its backward (K6b) and K6b's backward (K6bb) for Hopper
// (sm_90a).
//
// These kernels replace no Pallas kernel.  The JAX package leaves the radial
// terms to XLA, which fuses the per-lane Gaussians, the cutoff, the masks and
// the per-species sums into a few passes; eager PyTorch cannot fuse them, and
// its plain version (radial_aev_reference) writes and reads (N, K, R) float32
// tensors some seven times forward, for each present species once more, and
// about as often again in each backward.  For every centre atom (row n) of a
// radial table of K lanes, with d_k the lane's distance and e_k its species
// (-1 in a masked lane):
//
//   K6:   out[n, e, r] = sum_{k: e_k = e} T_r(d_k),
//         T_r(d) = 0.25 exp(-eta (d - ShfR_r)^2) fc(d),
//
// species-major, (N, S * R) f32: the layout the AEV computer writes.
//   K6b:  gdist[n, k] = sum_r g[n, e_k, r] T'_r(d_k), 0 in a masked lane,
//   K6bb: gg[n, e, r] = sum_{k: e_k = e} w[n, k] T'_r(d_k) and
//         gdist[n, k] = w[n, k] sum_r g[n, e_k, r] T''_r(d_k),
//
// with T' = 0.25 E (fc' - 2 eta (d - ShfR) fc), E = exp(-eta (d - ShfR)^2),
// and T'' = 0.25 (E'' fc + 2 E' fc' + E fc'').  g is read with a row stride
// (the radial block of the AEV's cotangent is a column slice).
//
// What bounds them on this card: bytes.  Each lane's species is needed once
// (4 bytes as an int32, the width K3 takes; these kernels read the int64
// table that the neighbor lists hold, 8 bytes, and the bound does not charge
// the difference), its distance (4) where the lane is valid, and K6bb's
// direction (4) too; a row's S * R floats are written (K6, K6bb) or read
// (K6b, K6bb) once: ~8 B a lane plus 4 S R B a row.  At the E+F batch
// (153,600 rows of 60 lanes, 1.66 M of them valid, S = 7, R = 16) K6 needs
// ~112 MB, 0.034 ms at 3.35 TB/s; the 17 special-function instructions a
// valid lane (16 exp and a cos) take ~0.007 ms.  Eager PyTorch moved tens
// of GB for the same forward and backward.  On an H100 (700 W), at the E+F
// tables and at the 59,049-atom water box's (K = 112): K6 0.114 and 0.155
// ms against bounds of 0.034 and 0.020, K6b 0.103 and 0.077 (0.035, 0.028),
// K6bb 0.226 and 0.235 (0.057, 0.040); their plain versions 7-16 ms.
//
// Design (all three):
// - one warp a row, four rows a block; a row's lanes are taken 32 at a
//   time, each lane loading its own species and, only where it is valid,
//   its distance, and forming its cutoff (and derivatives) once.  A row with
//   no valid lane (a padding atom, ~42% of the E+F rows) reads its species,
//   writes its zeros and nothing else: its cotangent row is never read;
// - sums over lanes into (S, R) (K6, K6bb's gg): lane l of the warp holds
//   shift r = l mod R of lane group l / R (32 / R groups, 2 at R = 16); the
//   valid lanes of a chunk, found by one ballot, are handed out one to a
//   group, their (d, fc, ...) broadcast by shuffles; each thread keeps one
//   f32 sum a species in registers (a predicated add a species, no dynamic
//   register index), so no (N, K, R) tensor and no shared memory is needed;
//   the groups' sums meet by shuffles and the first group writes the row,
//   R consecutive floats a species;
// - sums over shifts (K6b, K6bb's gdist): the row's S x R cotangents are
//   staged into shared memory (rows R + 1 floats apart, so lanes of
//   different species read different banks) the first time a chunk holds a
//   valid lane, and each lane sums its R terms in registers;
// - the order of every sum is fixed: results repeat bit for bit.
// Compiled without --use_fast_math: expf, cosf and sinf keep their
// full-precision forms, as K3 does (csrc/angular_aev.cu).
// Templates: S = 7 and S = 4 (ANI-2x, ANI-1x) at R = 16 are compiled with
// constant bounds; other widths up to 16 species and 32 shifts take the
// generic instantiation (<0, 0>), whose loops run to the maxima with guards.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxShifts = 32;
constexpr int kMaxSpecies = 16;
constexpr unsigned kFullMask = 0xffffffffu;

struct RadialParams {
  float shift[kMaxShifts];  // ShfR
  int n;
  int k;
  int num_species;
  int num_shifts;
  float eta;
  float cutoff;
  float pi_over_cutoff;
  int cutoff_kind;  // 0 cosine, 1 smooth (order 2, eps 1e-10)
};

// fc(r) and, up to kOrder, fc'(r) and fc''(r): the cutoffs of
// torchani_tpu_torch/cutoffs.py and their derivatives as
// aev/kernels.py:_cutoff_and_derivative and _cutoff_second_derivative
// write them (0 past the smooth cutoff's clamp)
template <int kOrder>
__device__ __forceinline__ void cutoff_fn(float r, const RadialParams& p, float& fc, float& d1,
                                          float& d2) {
  if (p.cutoff_kind == 0) {
    const float arg = r * p.pi_over_cutoff;
    const float c = cosf(arg);
    fc = 0.5f * c + 0.5f;
    if (kOrder >= 1) {
      d1 = -0.5f * p.pi_over_cutoff * sinf(arg);
    }
    if (kOrder >= 2) {
      d2 = -0.5f * (p.pi_over_cutoff * p.pi_over_cutoff) * c;
    }
  } else {
    const float x = r / p.cutoff;
    const float u = 1.0f - x * x;
    const float uc = fmaxf(u, 1e-10f);
    fc = expf(1.0f - 1.0f / uc);
    const float t = -2.0f * x / p.cutoff;  // du/dr
    const bool inside = u >= 1e-10f;
    const float dfc = inside ? fc * t / (uc * uc) : 0.0f;
    if (kOrder >= 1) {
      d1 = dfc;
    }
    if (kOrder >= 2) {
      d2 = inside ? dfc * t / (uc * uc) - 2.0f * fc / (p.cutoff * p.cutoff * uc * uc) -
                        2.0f * fc * t * t / (uc * uc * uc)
                  : 0.0f;
    }
  }
}

// this thread's shift of the sums over lanes, without a dynamic index into
// the parameters (which would copy them to local memory)
__device__ __forceinline__ float my_shift(const RadialParams& p, int r) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxShifts; ++i) {
    s = i == r ? p.shift[i] : s;
  }
  return s;
}

// Hands the next valid lanes of `bits` (a warp-uniform ballot) out one to a
// lane group, in lane order: returns this group's lane (its source for the
// shuffles) and whether it has one.  Every thread runs the same loop.
__device__ __forceinline__ int take_lane(unsigned& bits, int groups, int group, bool& have) {
  int src = 0;
  have = false;
  for (int i = 0; i < groups && bits != 0u; ++i) {
    const int j = __ffs(bits) - 1;
    bits &= bits - 1u;
    if (i == group) {
      src = j;
      have = true;
    }
  }
  return src;
}

// a lane of the row: its species where valid (0 <= e < S), else -1
__device__ __forceinline__ int lane_species(const long long* __restrict__ species, size_t base,
                                            int l, const RadialParams& p) {
  if (l >= p.k) {
    return -1;
  }
  const long long e = species[base + l];
  return e >= 0 && e < p.num_species ? static_cast<int>(e) : -1;
}

// Sums over the groups' per-species sums into the first group and writes
// the row there: out[row, e * R + r]
template <int kS>
__device__ __forceinline__ void write_species_sums(float (&acc)[kS ? kS : kMaxSpecies],
                                                   float* __restrict__ out, size_t row, int lane,
                                                   int groups, int nr, int ns) {
  constexpr int kAcc = kS ? kS : kMaxSpecies;
#pragma unroll
  for (int s = 0; s < kAcc; ++s) {
    float total = acc[s];
    for (int g = 1; g < groups; ++g) {
      total += __shfl_sync(kFullMask, acc[s], (lane + g * nr) & 31);
    }
    acc[s] = total;
  }
  if (lane < nr) {
    float* dst = out + row * static_cast<size_t>(ns * nr) + lane;
#pragma unroll
    for (int s = 0; s < kAcc; ++s) {
      if (kS || s < ns) {
        dst[s * nr] = acc[s];
      }
    }
  }
}

// Copies the row's S x R cotangent (row stride `g_stride`) into the warp's
// shared rows, R + 1 floats apart
__device__ __forceinline__ void stage_cotangent(const float* __restrict__ g, long long g_stride,
                                                size_t row, int lane, int ns, int nr,
                                                float* gs) {
  const float* src = g + row * static_cast<size_t>(g_stride);
  for (int i = lane; i < ns * nr; i += 32) {
    const int s = i / nr;
    gs[s * (nr + 1) + (i - s * nr)] = src[i];
  }
  __syncwarp();
}

// K6: one warp a row
template <int kS, int kR>
__global__ void __launch_bounds__(kThreads)
    radial_aev_kernel(const float* __restrict__ dist, const long long* __restrict__ species,
                      float* __restrict__ out, const RadialParams p) {
  constexpr int kAcc = kS ? kS : kMaxSpecies;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= p.n) {
    return;  // the whole warp
  }
  const int ns = kS ? kS : p.num_species;
  const int nr = kR ? kR : p.num_shifts;
  const int groups = 32 / nr;
  const int group = lane / nr;
  const int r = lane - group * nr;
  const bool active = group < groups;
  const float shift = my_shift(p, r);
  const float neg_eta = -p.eta;
  const size_t base = static_cast<size_t>(row) * p.k;
  float acc[kAcc];
#pragma unroll
  for (int s = 0; s < kAcc; ++s) {
    acc[s] = 0.0f;
  }
  for (int b = 0; b < p.k; b += 32) {
    const int e = lane_species(species, base, b + lane, p);
    float d = 0.0f, fc4 = 0.0f;
    if (e >= 0) {
      float fc, unused1, unused2;
      d = dist[base + b + lane];
      cutoff_fn<0>(d, p, fc, unused1, unused2);
      fc4 = 0.25f * fc;
    }
    unsigned bits = __ballot_sync(kFullMask, e >= 0);
    while (bits != 0u) {
      bool have;
      const int src = take_lane(bits, groups, group, have);
      const float dj = __shfl_sync(kFullMask, d, src);
      const float fj = __shfl_sync(kFullMask, fc4, src);
      const int ej = __shfl_sync(kFullMask, e, src);
      if (have && active) {
        const float dr = dj - shift;
        const float v = fj * expf(neg_eta * (dr * dr));
#pragma unroll
        for (int s = 0; s < kAcc; ++s) {
          acc[s] += ej == s ? v : 0.0f;
        }
      }
    }
  }
  write_species_sums<kS>(acc, out, row, lane, groups, nr, ns);
}

// K6b: one warp a row, one thread a lane
template <int kS, int kR>
__global__ void __launch_bounds__(kThreads)
    radial_aev_bwd_kernel(const float* __restrict__ g, long long g_stride,
                          const float* __restrict__ dist, const long long* __restrict__ species,
                          float* __restrict__ gdist, const RadialParams p) {
  constexpr int kRMax = kR ? kR : kMaxShifts;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= p.n) {
    return;
  }
  const int ns = kS ? kS : p.num_species;
  const int nr = kR ? kR : p.num_shifts;
  float* gs = smem + warp * ns * (nr + 1);
  const float neg_eta = -p.eta;
  const float two_eta = 2.0f * p.eta;
  const size_t base = static_cast<size_t>(row) * p.k;
  bool staged = false;
  for (int b = 0; b < p.k; b += 32) {
    const int l = b + lane;
    const int e = lane_species(species, base, l, p);
    if (!staged && __ballot_sync(kFullMask, e >= 0) != 0u) {
      stage_cotangent(g, g_stride, row, lane, ns, nr, gs);
      staged = true;
    }
    float sum = 0.0f;
    if (e >= 0) {
      const float d = dist[base + l];
      float fc, dfc, unused;
      cutoff_fn<1>(d, p, fc, dfc, unused);
      const float* gr = gs + e * (nr + 1);
#pragma unroll
      for (int i = 0; i < kRMax; ++i) {
        if (kR || i < nr) {
          const float dr = d - p.shift[i];
          const float quarter_e = 0.25f * expf(neg_eta * (dr * dr));
          sum += gr[i] * (quarter_e * (dfc - two_eta * dr * fc));
        }
      }
    }
    if (l < p.k) {
      gdist[base + l] = sum;
    }
  }
}

// K6bb: gg by K6's sums over lanes, gdist by K6b's sums over shifts, in one
// pass over the row's lanes
template <int kS, int kR>
__global__ void __launch_bounds__(kThreads)
    radial_aev_bwd_bwd_kernel(const float* __restrict__ g, long long g_stride,
                              const float* __restrict__ dist,
                              const long long* __restrict__ species,
                              const float* __restrict__ w, float* __restrict__ gg,
                              float* __restrict__ gdist, const RadialParams p) {
  constexpr int kAcc = kS ? kS : kMaxSpecies;
  constexpr int kRMax = kR ? kR : kMaxShifts;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= p.n) {
    return;
  }
  const int ns = kS ? kS : p.num_species;
  const int nr = kR ? kR : p.num_shifts;
  const int groups = 32 / nr;
  const int group = lane / nr;
  const int r = lane - group * nr;
  const bool active = group < groups;
  const float shift = my_shift(p, r);
  const float neg_eta = -p.eta;
  const float two_eta = 2.0f * p.eta;
  float* gs = smem + warp * ns * (nr + 1);
  const size_t base = static_cast<size_t>(row) * p.k;
  float acc[kAcc];
#pragma unroll
  for (int s = 0; s < kAcc; ++s) {
    acc[s] = 0.0f;
  }
  bool staged = false;
  for (int b = 0; b < p.k; b += 32) {
    const int l = b + lane;
    const int e = lane_species(species, base, l, p);
    unsigned bits = __ballot_sync(kFullMask, e >= 0);
    float d = 0.0f, fc = 0.0f, dfc = 0.0f, wk = 0.0f;
    float d2fc = 0.0f;
    if (e >= 0) {
      d = dist[base + l];
      wk = w[base + l];
      cutoff_fn<2>(d, p, fc, dfc, d2fc);
    }
    if (!staged && bits != 0u) {
      stage_cotangent(g, g_stride, row, lane, ns, nr, gs);
      staged = true;
    }
    float sum = 0.0f;
    if (e >= 0) {
      const float* gr = gs + e * (nr + 1);
#pragma unroll
      for (int i = 0; i < kRMax; ++i) {
        if (kR || i < nr) {
          const float dr = d - p.shift[i];
          const float ex = expf(neg_eta * (dr * dr));
          const float e1 = -two_eta * dr * ex;
          const float e2 = (two_eta * two_eta * (dr * dr) - two_eta) * ex;
          sum += gr[i] * (0.25f * (e2 * fc + 2.0f * e1 * dfc + ex * d2fc));
        }
      }
    }
    if (l < p.k) {
      gdist[base + l] = wk * sum;
    }
    while (bits != 0u) {
      bool have;
      const int src = take_lane(bits, groups, group, have);
      const float dj = __shfl_sync(kFullMask, d, src);
      const float fj = __shfl_sync(kFullMask, fc, src);
      const float dfj = __shfl_sync(kFullMask, dfc, src);
      const float wj = __shfl_sync(kFullMask, wk, src);
      const int ej = __shfl_sync(kFullMask, e, src);
      if (have && active) {
        const float dr = dj - shift;
        const float quarter_e = 0.25f * expf(neg_eta * (dr * dr));
        const float v = wj * (quarter_e * (dfj - two_eta * dr * fj));
#pragma unroll
        for (int s = 0; s < kAcc; ++s) {
          acc[s] += ej == s ? v : 0.0f;
        }
      }
    }
  }
  write_species_sums<kS>(acc, gg, row, lane, groups, nr, ns);
}

using FwdKernel = void (*)(const float*, const long long*, float*, const RadialParams);
using BwdKernel = void (*)(const float*, long long, const float*, const long long*, float*,
                           const RadialParams);
using BwdBwdKernel = void (*)(const float*, long long, const float*, const long long*,
                              const float*, float*, float*, const RadialParams);

// the instantiations for these widths: ANI-2x's and ANI-1x's, else generic
FwdKernel pick_fwd(int num_species, int num_shifts) {
  if (num_shifts == 16 && num_species == 7) {
    return radial_aev_kernel<7, 16>;
  }
  if (num_shifts == 16 && num_species == 4) {
    return radial_aev_kernel<4, 16>;
  }
  return radial_aev_kernel<0, 0>;
}

BwdKernel pick_bwd(int num_species, int num_shifts) {
  if (num_shifts == 16 && num_species == 7) {
    return radial_aev_bwd_kernel<7, 16>;
  }
  if (num_shifts == 16 && num_species == 4) {
    return radial_aev_bwd_kernel<4, 16>;
  }
  return radial_aev_bwd_kernel<0, 0>;
}

BwdBwdKernel pick_bwd_bwd(int num_species, int num_shifts) {
  if (num_shifts == 16 && num_species == 7) {
    return radial_aev_bwd_bwd_kernel<7, 16>;
  }
  if (num_shifts == 16 && num_species == 4) {
    return radial_aev_bwd_bwd_kernel<4, 16>;
  }
  return radial_aev_bwd_bwd_kernel<0, 0>;
}

cudaError_t make_params(RadialParams& p, int n, int k, int num_species, const float* shifts,
                        int num_shifts, float eta, float cutoff, float pi_over_cutoff,
                        int cutoff_kind) {
  if (n < 0 || k < 0 || num_species < 1 || num_species > kMaxSpecies || num_shifts < 1 ||
      num_shifts > kMaxShifts || (cutoff_kind != 0 && cutoff_kind != 1)) {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < kMaxShifts; ++i) {
    p.shift[i] = i < num_shifts ? shifts[i] : 0.0f;
  }
  p.n = n;
  p.k = k;
  p.num_species = num_species;
  p.num_shifts = num_shifts;
  p.eta = eta;
  p.cutoff = cutoff;
  p.pi_over_cutoff = pi_over_cutoff;
  p.cutoff_kind = cutoff_kind;
  return cudaSuccess;
}

int blocks_for(int n) { return (n + kWarpsPerBlock - 1) / kWarpsPerBlock; }

size_t staged_bytes(const RadialParams& p) {
  return static_cast<size_t>(kWarpsPerBlock) * p.num_species * (p.num_shifts + 1) *
         sizeof(float);
}

}  // namespace

extern "C" {

// All three launch on `stream` (a cudaStream_t) of `device` and return the
// cudaError_t of the launch (0 on success).  `dist` (N, K), `species` (N,
// K) int64 (-1 in masked lanes), `w` (N, K) and the outputs are contiguous
// device arrays; `g` is a device array of N rows of S * R floats whose rows
// are `g_row_stride` floats apart, its columns contiguous.  `shifts` is a
// host array.

int radial_aev_launch(const float* dist, const long long* species, float* out, int n, int k,
                      int num_species, const float* shifts, int num_shifts, float eta,
                      float cutoff, float pi_over_cutoff, int cutoff_kind, int device,
                      void* stream) {
  RadialParams p;
  cudaError_t err = make_params(p, n, k, num_species, shifts, num_shifts, eta, cutoff,
                                pi_over_cutoff, cutoff_kind);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const FwdKernel kernel = pick_fwd(num_species, num_shifts);
  kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(dist, species, out,
                                                                             p);
  return static_cast<int>(cudaGetLastError());
}

int radial_aev_bwd_launch(const float* g, long long g_row_stride, const float* dist,
                          const long long* species, float* gdist, int n, int k, int num_species,
                          const float* shifts, int num_shifts, float eta, float cutoff,
                          float pi_over_cutoff, int cutoff_kind, int device, void* stream) {
  RadialParams p;
  cudaError_t err = make_params(p, n, k, num_species, shifts, num_shifts, eta, cutoff,
                                pi_over_cutoff, cutoff_kind);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (g_row_stride < static_cast<long long>(num_species) * num_shifts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const BwdKernel kernel = pick_bwd(num_species, num_shifts);
  kernel<<<blocks_for(n), kThreads, staged_bytes(p), static_cast<cudaStream_t>(stream)>>>(
      g, g_row_stride, dist, species, gdist, p);
  return static_cast<int>(cudaGetLastError());
}

// K6bb: `w` (N, K) is the cotangent of K6b's output; writes gg (N, S * R)
// and gdist (N, K)
int radial_aev_bwd_bwd_launch(const float* g, long long g_row_stride, const float* dist,
                              const long long* species, const float* w, float* gg, float* gdist,
                              int n, int k, int num_species, const float* shifts,
                              int num_shifts, float eta, float cutoff, float pi_over_cutoff,
                              int cutoff_kind, int device, void* stream) {
  RadialParams p;
  cudaError_t err = make_params(p, n, k, num_species, shifts, num_shifts, eta, cutoff,
                                pi_over_cutoff, cutoff_kind);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (g_row_stride < static_cast<long long>(num_species) * num_shifts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const BwdBwdKernel kernel = pick_bwd_bwd(num_species, num_shifts);
  kernel<<<blocks_for(n), kThreads, staged_bytes(p), static_cast<cudaStream_t>(stream)>>>(
      g, g_row_stride, dist, species, w, gg, gdist, p);
  return static_cast<int>(cudaGetLastError());
}

const char* radial_aev_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
