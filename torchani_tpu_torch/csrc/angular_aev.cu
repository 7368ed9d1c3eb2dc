// Fused angular AEV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_angular_kernel` reached through
// `angular_aev_pallas` (torchani_tpu/aev/pallas_kernels.py:28-208, the
// pallas_call at :186).  Same contract: for every centre atom, the sum over
// unordered neighbour pairs {j, k} (j != k, both lanes valid) of
//
//   exp(-eta (mean_r - ShfA_z)^2) * 2 ((1 + c cos(s_z) + sin(theta) sin(s_z)) / 2)^zeta
//     * fc(r_j) fc(r_k),   c = 0.95 (d_j . d_k) / (r_j r_k),
//     sin(theta) = sqrt(max(1 - c^2, 1e-20)),
//
// for each feature z = shift * num_sections + section, accumulated into the
// packed species-pair slot triu(min(s_j, s_k), max(s_j, s_k)).  Output is
// (N, P * Z) f32, pair-major.  The (N, Ka, Ka, Z) terms never leave the SM.
//
// What bounds it on this card, counted as chip_smoke.py counts it (valid
// pairs only): at the 10,002-atom water box (Ka = 28, Z = 32) about 120 of
// the 378 grid pairs per atom are valid, 1.2e6 pairs or 3.9e7 terms.  With
// expf and powf counted as one FP32 operation each (15 per term) that is
// ~9 us at the FP32 peak, below the ~14 us that the ~48 MB of input and
// output take at 3.35 TB/s: bytes bind.  Counted on the special-function
// units instead (an exp, a log and an exp per term) it is ~28 us, and then
// arithmetic binds.
//
// Design:
// - one warp per centre atom, four atoms per block; the atom's Ka lanes
//   (r, dx, dy, dz, species with -1 for a masked lane, fc) are staged in
//   shared memory once;
// - each pair's geometry (c, sin theta, mean r, fc_j fc_k, slot) is computed
//   once, for j < k only, one pair per lane, and broadcast to the warp with
//   shuffles; pairs with a masked lane are skipped before any division, so
//   padded r is never used;
// - lanes stride over z (lane, lane + 32) with their per-z constants in
//   registers, so the expf/powf work spreads over all 32 lanes;
// - each lane owns its z column of a P x Z accumulator tile in shared
//   memory (bank = z), so no atomics are needed; the tile is written out
//   coalesced at the end.
// Compiled without --use_fast_math: expf, powf, sqrtf and cosf stay at full
// precision (the parity target against the plain version is 1e-5).

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxZ = 64;
constexpr int kZPerLane = kMaxZ / 32;
constexpr unsigned kFullMask = 0xffffffffu;

struct AngularParams {
  float shift[kMaxZ];   // ShfA of feature z
  float cossec[kMaxZ];  // cos(section of feature z)
  float sinsec[kMaxZ];  // sin(section of feature z)
  int n;
  int ka;
  int num_species;
  int num_pairs;
  int num_z;
  float eta;
  float zeta;
  float cutoff;
  float pi_over_cutoff;
  int cutoff_kind;  // 0 cosine, 1 smooth (order 2, eps 1e-10)
};

__device__ __forceinline__ float cutoff_value(float r, const AngularParams& p) {
  if (p.cutoff_kind == 0) {
    return 0.5f * cosf(r * p.pi_over_cutoff) + 0.5f;
  }
  const float x = r / p.cutoff;
  const float e = 1.0f - 1.0f / fmaxf(1.0f - x * x, 1e-10f);
  return expf(e);
}

__device__ __forceinline__ int triu_slot(int a, int b, int s) {
  const int lo = min(a, b);
  const int hi = max(a, b);
  return lo * s - (lo * (lo - 1)) / 2 + (hi - lo);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
angular_aev_kernel(const float* __restrict__ dist,     // (N, Ka)
                   const float* __restrict__ diff,     // (N, Ka, 3)
                   const int* __restrict__ species,    // (N, Ka), -1 masked
                   float* __restrict__ out,            // (N, P * Z)
                   const AngularParams p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int atom = blockIdx.x * kWarpsPerBlock + warp;
  const int ka = p.ka;
  const int nz = p.num_z;
  const int pz = p.num_pairs * nz;

  float* acc = smem + warp * (pz + 6 * ka);
  float* lr = acc + pz;
  float* lx = lr + ka;
  float* ly = lx + ka;
  float* lz = ly + ka;
  float* lfc = lz + ka;
  int* lsp = reinterpret_cast<int*>(lfc + ka);

  if (atom >= p.n) {
    return;  // the whole warp leaves together; only __syncwarp is used below
  }

  for (int i = lane; i < pz; i += 32) {
    acc[i] = 0.0f;
  }
  const size_t row = static_cast<size_t>(atom) * ka;
  for (int j = lane; j < ka; j += 32) {
    const int s = species[row + j];
    const float r = dist[row + j];
    lr[j] = r;
    lx[j] = diff[(row + j) * 3 + 0];
    ly[j] = diff[(row + j) * 3 + 1];
    lz[j] = diff[(row + j) * 3 + 2];
    lsp[j] = s;
    lfc[j] = s >= 0 ? cutoff_value(r, p) : 0.0f;
  }

  float shift_r[kZPerLane], cos_r[kZPerLane], sin_r[kZPerLane];
#pragma unroll
  for (int q = 0; q < kZPerLane; ++q) {
    const int z = lane + 32 * q;
    shift_r[q] = z < nz ? p.shift[z] : 0.0f;
    cos_r[q] = z < nz ? p.cossec[z] : 0.0f;
    sin_r[q] = z < nz ? p.sinsec[z] : 0.0f;
  }
  __syncwarp();

  for (int j = 0; j + 1 < ka; ++j) {
    const int sj = lsp[j];
    if (sj < 0) {
      continue;  // warp-uniform
    }
    const float rj = lr[j], xj = lx[j], yj = ly[j], zj = lz[j], fcj = lfc[j];
    for (int k0 = j + 1; k0 < ka; k0 += 32) {
      const int k = k0 + lane;
      bool valid = false;
      float c = 0.0f, sin_t = 0.0f, mean = 0.0f, fc2 = 0.0f;
      int slot = 0;
      if (k < ka) {
        const int sk = lsp[k];
        if (sk >= 0) {
          valid = true;
          const float rk = lr[k];
          const float dot = xj * lx[k] + yj * ly[k] + zj * lz[k];
          c = 0.95f * dot / fmaxf(rj * rk, 1e-10f);
          sin_t = sqrtf(fmaxf(1.0f - c * c, 1e-20f));
          mean = 0.5f * (rj + rk);
          fc2 = fcj * lfc[k];
          slot = triu_slot(sj, sk, p.num_species);
        }
      }
      unsigned pending = __ballot_sync(kFullMask, valid);
      while (pending) {
        const int src = __ffs(pending) - 1;
        pending &= pending - 1;
        const float cq = __shfl_sync(kFullMask, c, src);
        const float sq = __shfl_sync(kFullMask, sin_t, src);
        const float mq = __shfl_sync(kFullMask, mean, src);
        const float fq = __shfl_sync(kFullMask, fc2, src);
        const int slotq = __shfl_sync(kFullMask, slot, src);
        float* tile = acc + slotq * nz;
#pragma unroll
        for (int q = 0; q < kZPerLane; ++q) {
          const int z = lane + 32 * q;
          if (z < nz) {
            const float dr = mq - shift_r[q];
            const float rad = expf(-p.eta * dr * dr);
            const float base = 0.5f * (1.0f + cq * cos_r[q] + sq * sin_r[q]);
            const float ang = 2.0f * powf(base, p.zeta);
            tile[z] += rad * ang * fq;
          }
        }
      }
    }
  }
  __syncwarp();

  float* dst = out + static_cast<size_t>(atom) * pz;
  for (int i = lane; i < pz; i += 32) {
    dst[i] = acc[i];
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of `device`.  Inputs are
// contiguous device arrays; `shifts`, `cos_sections` and `sin_sections` are
// host arrays.  Returns the cudaError_t of the launch (0 on success).
int angular_aev_launch(const float* dist, const float* diff, const int* species,
                       float* out, int n, int ka, int num_species,
                       const float* shifts, int num_shifts,
                       const float* cos_sections, const float* sin_sections,
                       int num_sections, float eta, float zeta, float cutoff,
                       float pi_over_cutoff, int cutoff_kind, int device,
                       void* stream) {
  const int nz = num_shifts * num_sections;
  if (n <= 0 || ka <= 0 || nz <= 0 || nz > kMaxZ || num_species <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  AngularParams p;
  for (int z = 0; z < nz; ++z) {
    p.shift[z] = shifts[z / num_sections];
    p.cossec[z] = cos_sections[z % num_sections];
    p.sinsec[z] = sin_sections[z % num_sections];
  }
  for (int z = nz; z < kMaxZ; ++z) {
    p.shift[z] = p.cossec[z] = p.sinsec[z] = 0.0f;
  }
  p.n = n;
  p.ka = ka;
  p.num_species = num_species;
  p.num_pairs = num_species * (num_species + 1) / 2;
  p.num_z = nz;
  p.eta = eta;
  p.zeta = zeta;
  p.cutoff = cutoff;
  p.pi_over_cutoff = pi_over_cutoff;
  p.cutoff_kind = cutoff_kind;

  const size_t smem =
      static_cast<size_t>(kWarpsPerBlock) * (p.num_pairs * nz + 6 * ka) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(angular_aev_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  angular_aev_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(dist, diff, species, out, p);
  return static_cast<int>(cudaGetLastError());
}

const char* angular_aev_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
