// Fused angular AEV (K3), its backward (K3b) and K3b's backward (K3bb) for
// Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel `_angular_kernel` reached through
// `angular_aev_pallas` (torchani_tpu/aev/pallas_kernels.py:28-208, the
// pallas_call at :186).  Same contract: for every centre atom, the sum over
// unordered neighbour pairs {j, k} (j != k, both lanes valid) of
//
//   T_z = R_a(m) A_b(c) F,   z = a * num_sections + b,
//   R_a = exp(-eta (m - ShfA_a)^2),   m = (r_j + r_k) / 2,
//   A_b = 2 ((1 + c cos(s_b) + sin(theta) sin(s_b)) / 2)^zeta,
//   c = 0.95 (d_j . d_k) / max(r_j r_k, 1e-10),
//   sin(theta) = sqrt(max(1 - c^2, 1e-20)),   F = fc(r_j) fc(r_k),
//
// accumulated into the packed species-pair slot triu(min(s_j, s_k),
// max(s_j, s_k)).  Output is (N, P * Z) f32, pair-major.  The (N, Ka, Ka, Z)
// terms never leave the SM.
//
// K3b is its backward: from the cotangent g (N, P * Z), read with a row
// stride (the angular block of the AEV's cotangent is a column slice), it
// gives gdist (N, Ka) and gdiff (N, Ka, 3).  The JAX package has no TPU
// kernel here: `_angular_pallas_bwd` (torchani_tpu/aev/computer.py:1045)
// recomputes the forward through XLA and differentiates it.  Per valid pair,
// with G_ab = g[slot, a * num_sections + b]:
//
//   dL/dm = F sum_a R'_a sum_b G_ab A_b
//   dL/dc = F sum_a R_a  sum_b G_ab A'_b
//   dL/dF =   sum_a R_a  sum_b G_ab A_b
//
// then through m, F = fc(r_j) fc(r_k) and c (dc/dr_j = -c / r_j where
// r_j r_k >= 1e-10, dc/dd_j = 0.95 d_k / max(r_j r_k, 1e-10)) onto both
// lanes of the pair.  A'_b = zeta base^(zeta - 1) (cos s_b + sin s_b
// dsin/dc), with base^(zeta - 1) 0 at base = 0, and dsin/dc = -c / sin(theta)
// inside the 1e-20 clamp, 0 past it.
//
// What bounds them on this card, counted as chip_smoke.py counts it (valid
// pairs only): at the 10,002-atom water box (Ka = 28, Z = 32 as 8 shifts x
// 4 sections) about 120 of the 378 grid pairs per atom are valid, 1.2e6
// pairs.  The term is separable, so a pair needs 8 exp and 4 pow (K3b: 4
// pow of zeta - 1), not 32 of each: ~1.2e6 x 18 special-function
// instructions (exp2, log2, rcp, rsqrt) take ~5 us at the card's 16 a clock
// per SM, and the f32 arithmetic ~3 us (K3) or ~5 us (K3b).  Bytes bind:
// ~41 MB (K3) and ~46 MB (K3b: the 36 MB cotangent, lanes and gradients)
// take ~12 and ~14 us at 3.35 TB/s.
//
// Design (both kernels):
// - one warp per centre atom, four atoms per block; the atom's valid lanes
//   (r, dx, dy, dz, fc, species; K3b also fc') are compacted into shared
//   memory first (K3: sorted by species, a ballot per species and 32
//   lanes), so the pair loop has no masked lane and no per-j branch;
// - lanes take the atom's nv (nv - 1) / 2 pairs 32 at a time, one pair a
//   lane, and compute its factors once: num_shifts exp and num_sections
//   pow, not one of each per feature.  pow is exp2(zeta log2(base)) rather
//   than powf, in fewer instructions (`pow_pos`).
// K3:
// - pairs in row-major order (`advance_pair`); each lane writes its pair's
//   F R_a and A_b into a per-warp tile (32 rows of an odd stride, so the 32
//   rows fall on 32 banks) and its slot; then lanes over z sum (F R_a) A_b
//   over the batch's pairs.  With lanes sorted by species the slot changes
//   only a few times along a row: runs of one slot are summed in registers
//   and added to the lane's own z column of the P x Z accumulator tile (bank
//   = z) when the slot changes, so no atomics are needed; the tile is
//   written out coalesced.
// K3b: what held its first design (one warp an atom, the row staged with
// plain loads, 2,501 blocks of 4 warps), timed apart on an H100 (ablated
// copies, torch.profiler): at the water box 0.064 ms, of which the staging and
// write-out alone take 0.023 and the 8 shared-memory atomics of a pair
// (compare-and-swap loops, `ATOMS.CAST.SPIN`: the card has no shared f32
// add) 0.009; the rest is the pair loop, whose dependent chains (5 IEEE
// divisions, a square root and a division for the pair's index among them)
// the 32 warps an SM do not hide.  A persistent grid that double-buffers the
// next atom's row (cp.async) was slower: its ~10 KB a warp and 72-121
// registers leave 20 warps an SM.  The design:
// - a persistent grid of one wave, 8 blocks of 4 warps an SM (at most 64
//   registers); warp w of W takes atoms w, w + W, ...;
// - of the atom's cotangent row it copies (cp.async) only the slots of the
//   species pairs among its valid lanes: the others meet no pair.  At the
//   water box that is 3 of ANI-2x's 28 slots, so the kernel reads ~4 MB of
//   the 36 MB cotangent (chip_smoke.py's bound counts those rows).  Asking
//   the next atom's row into L2 ahead was slower;
// - the row's slots are Z + 4 floats apart where Z is a multiple of 4 (Z + 1
//   else): a lane reads its slot 16 bytes at a time, and lanes reading
//   different slots at one z fall on 8 different groups of banks;
// - the valid lanes are compacted in lane order (`stage_bwd_lanes`: one
//   ballot per 32 lanes, every lane's loads issued at once; K3's species
//   order, a ballot per species, serialised the loads), each into two float4
//   records, (r, dx, dy, dz) and (fc, fc', 1 / r, species): 4 loads a pair;
// - pairs in rounds: in round d (1 <= d <= nv / 2) lane j of the compacted
//   list pairs with lane (j + d) mod nv, so within a round no two pairs
//   share a j or a k; pair q is j = q mod nv of round q / nv + 1 (for an
//   even nv the last round takes j < nv / 2 only), and a lane's q advances
//   by 32 a step without a division;
// - no division in the pair loop: 1 / max(r_j r_k, 1e-10) from the staged
//   1 / r, 1 / sin(theta) from rsqrtf, exp(-eta dr^2) as exp2f of a
//   prescaled exponent;
// - each lane adds the 4 values of each side (r, dx, dy, dz) into per-warp
//   planes with shared-memory atomics: the j side and the k side are
//   separate instructions, and within a round their addresses are distinct,
//   so two lanes collide only where a batch spans two rounds.  Holding the
//   sums in registers and passing the k side by shuffles would need rounds
//   of nv pairs a warp: at nv of 17 to 20 (the water box averages ~120
//   pairs an atom, nv ~ 16) that idles 38-47% of the lanes, against the 15%
//   the atomics cost.  The order of the sums changes from run to run;
// - masked lanes and fully masked rows are written as exact zeros.
// On an H100 it takes 0.043 ms at the water box (its first design 0.064);
// ablated the same way, ~0.028 ms of it is the pair loop's
// arithmetic and ~0.008 the atomics, against a bound of 0.0065 ms set by
// the special-function units once only the rows that meet a pair are read.
// K3bb is K3b's vector-Jacobian product, the angular AEV's second
// derivative (Hessians, force training).  It replaces no pallas_call: the
// JAX package differentiates `_angular_pallas_bwd`'s XLA recompute
// (torchani_tpu/aev/computer.py:1045) a second time.  From the cotangents
// u = (u_dist, u_diff) of K3b's outputs and K3b's own inputs it gives, in
// one launch, gg (N, P * Z) = J u, the AEV's derivative along u (the
// cotangent of g), and (hdist, hdiff) = sum_o g_o Hess(AEV_o) u, the
// derivative of K3b's formulas as they stand, clamps included.  Per valid
// pair, with S = F P0(m, c) the pair's share of <g, AEV>:
//
//   J u:  du(T_ab) = (dF R_a + F dm R'_a) A_b + (F dc R_a) A'_b
//   phi = P0 dF + F Pm dm + F Pc dc   (K3b's pair cotangents along u)
//   h   = grad phi, through F(r_j, r_k), m, c and du(F), du(c)
//
// where P0, Pm, Pc, Pmm, Pmc, Pcc are the sums over (a, b) of g_ab times
// R_a A_b, R'_a A_b, R_a A'_b, R''_a A_b, R'_a A'_b and R_a A''_b
// (angular_aev_bwd_bwd_reference spells out every term).  What bounds it
// on this card at the water box, counted as chip_smoke.py counts it: bytes,
// 54 MB (gg is a full (N, P * Z) output, 36 MB; the lanes and the direction
// read, the cotangent rows that meet a pair, hdist and hdiff), 0.016 ms at
// 3.35 TB/s, against 0.013 ms of f32 arithmetic (~720 operations a pair)
// and 0.006 ms of special functions (sh + 3 se + 1 a pair).
// Its first design (one warp an atom, 2,501 blocks of 4 warps, K3's tile
// sums for J u into a (P, Z) accumulator, K3b's CAS atomics) took 0.145 ms
// there; timed apart (ablated copies, torch.profiler, on an "NVIDIA H100
// 80GB HBM3, 700.00 W"):
// staging and write-out 0.029, the pair arithmetic 0.041, the atomics
// 0.020, the tile sums 0.055 (each lane walked every pair of a batch, 4
// shared loads and a slot check a pair).  The design:
// - K3b's persistent grid of one wave, 4 blocks of 4 warps an SM (at most
//   128 registers, ~54 KB of shared memory a block at ANI-2x's widths; 3
//   blocks an SM were 22% slower, and met-slot-only buffers at 5 or 6
//   blocks spilled and were slower too); the species of a warp's next atom
//   are loaded one atom ahead, so the cotangent rows of its met slots start
//   copying (cp.async) before its lanes are staged;
// - pairs in K3b's rounds, 32 at a time, no division (the round and lane
//   advance by 32 pairs a step); the pair terms' exp2 and log2 on the
//   special-function unit alone (`exp2_approx`): no IEEE division for
//   base^(zeta - 2);
// - the second-order values go to 4 copies of the lane planes, round d to
//   copy d mod 4: a batch spans at most 4 rounds and within a round no two
//   pairs share a j or a k, so no two lanes add to one address, and plain
//   shared loads and stores replace the CAS atomics (their cost went from
//   0.020 ms to nothing measurable); the sums' order is fixed;
// - J u: the batch's pairs are ordered by slot (a ballot per slot in the
//   batch), each writes its tile row (X_a, Y_a | A_b, A'_b as float2s) at
//   its place, and each lane sums its features over each slot's run of rows
//   (2 shared loads, 2 FMAs a row, no check), adding once per run to that
//   slot's accumulator row, of which only the met slots are zeroed and read;
// - gg is written 16 bytes a lane: the met slots from the accumulator, the
//   others as zeros from registers.
// Compiled without --use_fast_math: expf, log2f, exp2f, sqrtf, cosf and sinf
// keep their full-precision forms (the parity target against the plain
// version is 1e-5); K3b's rsqrtf and reciprocals are within a few units of
// the last place, and so are K3bb's `exp2_approx` and `log2_approx`.
// Templates: the widths 8 x 4 (ANI-2x) and 4 x 8 (ANI-1x) are compiled with
// constant loop bounds; other widths up to 16 x 16 take the generic
// instantiation (<0, 0>), whose loops run to 16 with guards.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
// K3b: blocks an SM must hold (bounds its registers at 64 a thread)
constexpr int kBwdBlocksPerSM = 8;
constexpr int kMaxShifts = 16;
constexpr int kMaxSections = 16;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kMaxSharedBytes = 227 * 1024;

struct AngularParams {
  float shift[kMaxShifts];     // ShfA
  float cossec[kMaxSections];  // cos(section)
  float sinsec[kMaxSections];  // sin(section)
  int n;
  int ka;
  int num_species;
  int num_pairs;
  int num_shifts;
  int num_sections;
  float eta;
  float zeta;
  float cutoff;
  float pi_over_cutoff;
  int cutoff_kind;  // 0 cosine, 1 smooth (order 2, eps 1e-10)
};

// row stride of K3's per-pair factor tile: odd, so 32 rows hit 32 banks
__host__ __device__ __forceinline__ int tile_stride(int sh, int se) {
  return (sh + se) | 1;
}

// floats of shared memory per warp
__host__ __device__ __forceinline__ size_t fwd_warp_floats(int num_pairs, int nz, int ts,
                                                           int ka) {
  // acc (P, Z) | tile (32, ts) | slots (32) | r, x, y, z, fc, species (Ka each)
  return static_cast<size_t>(num_pairs) * nz + 32 * ts + 32 + 6 * static_cast<size_t>(ka);
}

// slot stride of K3b's staged cotangent: Z + 4 where Z is a multiple of 4
// (rows on 16 bytes, read 4 floats at a time; lanes reading different slots
// at one z fall on 8 different groups of banks), else Z + 1
__host__ __device__ __forceinline__ int bwd_slot_stride(int nz) {
  return nz % 4 == 0 ? nz + 4 : nz + 1;
}

__host__ __device__ __forceinline__ size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// floats of K3b's shared memory a warp: g (P, slot stride) | per compacted
// lane (r, x, y, z) and (fc, fc', 1 / r, species) as float4s | lane map (Ka)
// | gradient planes r, x, y, z (Ka each)
__host__ __device__ __forceinline__ size_t bwd_warp_floats(int num_pairs, int nz, int ka) {
  return round4(static_cast<size_t>(num_pairs) * bwd_slot_stride(nz)) +
         8 * static_cast<size_t>(ka) + round4(ka) + 4 * static_cast<size_t>(ka);
}

// 4-byte asynchronous copies from device to shared memory (cp.async): each
// lane waits for its own copies, and a __syncwarp then shows every lane's
// copies to the warp
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}

// waits until all of this lane's copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// fc(r) and, with kDeriv, fc'(r) (the cutoffs of torchani_tpu_torch/cutoffs.py)
template <bool kDeriv>
__device__ __forceinline__ void cutoff_fn(float r, const AngularParams& p, float& fc,
                                          float& dfc) {
  if (p.cutoff_kind == 0) {
    const float arg = r * p.pi_over_cutoff;
    fc = 0.5f * cosf(arg) + 0.5f;
    if (kDeriv) {
      dfc = -0.5f * p.pi_over_cutoff * sinf(arg);
    }
  } else {
    const float x = r / p.cutoff;
    const float u = 1.0f - x * x;
    const float uc = fmaxf(u, 1e-10f);
    fc = expf(1.0f - 1.0f / uc);
    if (kDeriv) {
      dfc = u >= 1e-10f ? fc * (-2.0f * x / p.cutoff) / (uc * uc) : 0.0f;
    }
  }
}

__device__ __forceinline__ int triu_slot(int a, int b, int s) {
  const int lo = min(a, b);
  const int hi = max(a, b);
  return lo * s - (lo * (lo - 1)) / 2 + (hi - lo);
}

// Stages the atom's valid lanes (species >= 0), compacted and sorted by
// species (stable), and returns their number (the same in every lane of the
// warp).  With `map`, map[l] is lane l's compacted index, -1 for a masked
// lane.
template <bool kDeriv>
__device__ int stage_lanes(const float* __restrict__ dist, const float* __restrict__ diff,
                           const int* __restrict__ species, size_t row, int lane,
                           const AngularParams& p, float* lr, float* lx, float* ly, float* lz,
                           float* lfc, float* ldfc, int* lsp, int* map) {
  if (map != nullptr) {
    for (int l = lane; l < p.ka; l += 32) {
      map[l] = -1;
    }
  }
  int nv = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int t = 0; t < p.num_species; ++t) {
    for (int base = 0; base < p.ka; base += 32) {
      const int l = base + lane;
      const bool mine = l < p.ka && species[row + l] == t;
      const unsigned found = __ballot_sync(kFullMask, mine);
      if (mine) {
        const int c = nv + __popc(found & below);
        const float r = dist[row + l];
        float fc, dfc = 0.0f;
        cutoff_fn<kDeriv>(r, p, fc, dfc);
        lr[c] = r;
        lx[c] = diff[(row + l) * 3 + 0];
        ly[c] = diff[(row + l) * 3 + 1];
        lz[c] = diff[(row + l) * 3 + 2];
        lfc[c] = fc;
        if (kDeriv) {
          ldfc[c] = dfc;
        }
        lsp[c] = t;
        if (map != nullptr) {
          map[l] = c;
        }
      }
      nv += __popc(found);
    }
  }
  return nv;
}

// Advances a lane's pair (j, k), j < k < nv, by `step` places in row-major
// order; past the last pair j is nv - 1.
__device__ __forceinline__ void advance_pair(int step, int nv, int& j, int& k) {
  k += step;
  while (k >= nv && j < nv - 1) {
    ++j;
    k += j + 1 - nv;
  }
}

// base^e for base >= 0 and e > 0, as exp2(e log2(base)): 0 at base = 0.
// Its relative error grows with |e log2(base)| (a few 1e-6 at |e log2| = 30,
// where the result is already below 2^-29), so it stays within a few units
// of the last place of powf where the result matters, in fewer instructions.
__device__ __forceinline__ float pow_pos(float base, float e) {
  return exp2f(e * log2f(base));
}

// 2^x and log2(x) by the special-function unit alone (ex2.approx,
// lg2.approx, denormals flushed): within 2 units of the last place (lg2:
// 2^-22 absolute), and 2^-inf = 0, log2(0) = -inf as in exp2f and log2f.
// K3bb's pair terms take these: its outputs stay within 1e-6 of max|p| of
// the full-precision forms, and K3bb takes 12% less time at the water box
// (on an "NVIDIA H100 80GB HBM3, 700.00 W").
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float log2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K3.  SH, SE > 0: the term's widths, as constants; 0: read from p.
template <int SH, int SE>
__global__ void __launch_bounds__(kThreads)
angular_aev_kernel(const float* __restrict__ dist,   // (N, Ka)
                   const float* __restrict__ diff,   // (N, Ka, 3)
                   const int* __restrict__ species,  // (N, Ka), -1 masked
                   float* __restrict__ out,          // (N, P * Z)
                   const AngularParams p) {
  constexpr int kSh = SH > 0 ? SH : kMaxShifts;
  constexpr int kSe = SE > 0 ? SE : kMaxSections;
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int atom = blockIdx.x * kWarpsPerBlock + warp;
  const int sh = SH > 0 ? SH : p.num_shifts;
  const int se = SE > 0 ? SE : p.num_sections;
  const int nz = sh * se;
  const int pz = p.num_pairs * nz;
  const int ka = p.ka;
  const int ts = tile_stride(sh, se);

  float* acc = smem + warp * fwd_warp_floats(p.num_pairs, nz, ts, ka);
  float* tile = acc + pz;
  int* tslot = reinterpret_cast<int*>(tile + 32 * ts);
  float* lr = reinterpret_cast<float*>(tslot + 32);
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
  const int nv = stage_lanes<false>(dist, diff, species, row, lane, p, lr, lx, ly, lz, lfc,
                                    nullptr, lsp, nullptr);
  __syncwarp();

  // this lane's features: z = lane + 32 i, at tile columns a(z) and sh + b(z)
  constexpr int kZPerLane = (kSh * kSe + 31) / 32;
  int col_a[kZPerLane], col_b[kZPerLane];
  float run[kZPerLane];
#pragma unroll
  for (int i = 0; i < kZPerLane; ++i) {
    const int z = lane + 32 * i;
    col_a[i] = z < nz ? z / se : 0;
    col_b[i] = z < nz ? sh + z % se : 0;
    run[i] = 0.0f;
  }
  int cur = -1;  // the slot `run` sums into (the same in every lane)

  const int num = nv * (nv - 1) / 2;
  int j = 0, k = 1;
  advance_pair(lane, nv, j, k);
  for (int q0 = 0; q0 < num; q0 += 32, advance_pair(32, nv, j, k)) {
    if (j < nv - 1) {
      const float rj = lr[j];
      const float rk = lr[k];
      const float dot = lx[j] * lx[k] + ly[j] * ly[k] + lz[j] * lz[k];
      const float c = 0.95f * dot / fmaxf(rj * rk, 1e-10f);
      const float sin_t = sqrtf(fmaxf(1.0f - c * c, 1e-20f));
      const float mean = 0.5f * (rj + rk);
      const float f = lfc[j] * lfc[k];
      float* t = tile + lane * ts;
#pragma unroll
      for (int a = 0; a < kSh; ++a) {
        if (a < sh) {
          const float dr = mean - p.shift[a];
          t[a] = f * expf(-p.eta * dr * dr);
        }
      }
#pragma unroll
      for (int b = 0; b < kSe; ++b) {
        if (b < se) {
          const float base = 0.5f * (1.0f + c * p.cossec[b] + sin_t * p.sinsec[b]);
          t[sh + b] = 2.0f * pow_pos(base, p.zeta);
        }
      }
      tslot[lane] = triu_slot(lsp[j], lsp[k], p.num_species);
    }
    __syncwarp();
    // lanes sorted by species and pairs in row-major order: the slot stays
    // the same over runs of pairs, summed in registers
    const int cnt = min(32, num - q0);
    for (int n = 0; n < cnt; ++n) {
      const int slot = tslot[n];
      if (slot != cur) {
        if (cur >= 0) {
#pragma unroll
          for (int i = 0; i < kZPerLane; ++i) {
            if (lane + 32 * i < nz) {
              acc[cur * nz + lane + 32 * i] += run[i];
            }
            run[i] = 0.0f;
          }
        }
        cur = slot;
      }
      const float* t = tile + n * ts;
#pragma unroll
      for (int i = 0; i < kZPerLane; ++i) {
        run[i] += t[col_a[i]] * t[col_b[i]];
      }
    }
    __syncwarp();
  }
  if (cur >= 0) {
#pragma unroll
    for (int i = 0; i < kZPerLane; ++i) {
      if (lane + 32 * i < nz) {
        acc[cur * nz + lane + 32 * i] += run[i];
      }
    }
  }
  __syncwarp();

  float* o = out + static_cast<size_t>(atom) * pz;
  for (int i = lane; i < pz; i += 32) {
    o[i] = acc[i];
  }
}

// Starts copying the rows of an atom's cotangent that its pairs read, those
// of the species pairs among its nv staged lanes (slot rows `bwd_slot_stride`
// floats apart): for a water box 3 of the 28 rows of ANI-2x.
__device__ __forceinline__ void copy_slot_rows(const float* __restrict__ grow, int lane, int nv,
                                               const float4* lb, int num_species, int nz,
                                               float* gs) {
  unsigned present = 0;
  for (int c = lane; c < nv; c += 32) {
    present |= 1u << __float_as_int(lb[c].w);
  }
  present = __reduce_or_sync(kFullMask, present);
  const int gz = bwd_slot_stride(nz);
  for (unsigned ms = present; ms != 0; ms &= ms - 1) {
    const int s = __ffs(ms) - 1;
    for (unsigned mt = present >> s; mt != 0; mt &= mt - 1) {
      const int slot = triu_slot(s, s + __ffs(mt) - 1, num_species);
      for (int i = lane; i < nz; i += 32) {
        cp_async4(gs + slot * gz + i, grow + slot * nz + i);
      }
    }
  }
}

// K3b's staging of an atom's valid lanes (species >= 0), compacted in lane
// order: K3b reads each pair's slot, so it needs no species order, and one
// ballot per 32 lanes stands in for `stage_lanes`'s one per species.  Each
// lane's loads are issued together.  Returns their number (the same in
// every lane of the warp); map[l] is lane l's compacted index, -1 for a
// masked lane; la[c] = (r, dx, dy, dz), lb[c] = (fc, fc', 1 / r, species
// bits) of compacted lane c.
__device__ int stage_bwd_lanes(const float* __restrict__ dist, const float* __restrict__ diff,
                               const int* __restrict__ species, size_t row, int lane,
                               const AngularParams& p, float4* la, float4* lb, int* map) {
  int nv = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < p.ka; base += 32) {
    const int l = base + lane;
    const bool in = l < p.ka;
    const int t = in ? species[row + l] : -1;
    const float r = in ? dist[row + l] : 1.0f;
    const float dx = in ? diff[(row + l) * 3 + 0] : 0.0f;
    const float dy = in ? diff[(row + l) * 3 + 1] : 0.0f;
    const float dz = in ? diff[(row + l) * 3 + 2] : 0.0f;
    const bool mine = t >= 0;
    const unsigned found = __ballot_sync(kFullMask, mine);
    const int c = nv + __popc(found & below);
    if (in) {
      map[l] = mine ? c : -1;
    }
    if (mine) {
      float fc, dfc;
      cutoff_fn<true>(r, p, fc, dfc);
      la[c] = make_float4(r, dx, dy, dz);
      lb[c] = make_float4(fc, dfc, 1.0f / r, __int_as_float(t));
    }
    nv += __popc(found);
  }
  return nv;
}

// What pair {j, k} adds to its lanes: v[0..3] to r, x, y, z of j and v[4..7]
// to those of k.  No division: 1 / max(r_j r_k, 1e-10) comes from the lanes'
// staged 1 / r, 1 / sin(theta) from a reciprocal square root, and
// exp(-eta dr^2) is exp2 of a prescaled exponent.
template <int SH, int SE>
__device__ __forceinline__ void pair_grads(int j, int k, const float4* la, const float4* lb,
                                           const float* gs, int gz, const AngularParams& p,
                                           float* v) {
  constexpr int kSh = SH > 0 ? SH : kMaxShifts;
  constexpr int kSe = SE > 0 ? SE : kMaxSections;
  const int sh = SH > 0 ? SH : p.num_shifts;
  const int se = SE > 0 ? SE : p.num_sections;
  const float4 aj = la[j], ak = la[k];
  const float4 bj = lb[j], bk = lb[k];
  const float rr = aj.x * ak.x;
  const bool through_r = rr >= 1e-10f;
  const float inv_den = through_r ? bj.z * bk.z : 1e10f;
  const float c = 0.95f * (aj.y * ak.y + aj.z * ak.z + aj.w * ak.w) * inv_den;
  const float s2 = 1.0f - c * c;
  const float s2c = fmaxf(s2, 1e-20f);
  const float inv_sin = rsqrtf(s2c);
  const float sin_t = s2c * inv_sin;
  const float dsin = s2 > 1e-20f ? -c * inv_sin : 0.0f;
  const float mean = 0.5f * (aj.x + ak.x);
  const float f = bj.x * bk.x;
  const float zeta_m1 = p.zeta - 1.0f;

  float ang[kSe], dang[kSe];
#pragma unroll
  for (int b = 0; b < kSe; ++b) {
    ang[b] = 0.0f;
    dang[b] = 0.0f;
    if (b < se) {
      const float cs = p.cossec[b];
      const float sn = p.sinsec[b];
      const float base = 0.5f * (1.0f + c * cs + sin_t * sn);
      const float pw = zeta_m1 > 0.0f ? pow_pos(base, zeta_m1) : 1.0f;
      ang[b] = 2.0f * base * pw;
      dang[b] = p.zeta * pw * (cs + sn * dsin);
    }
  }
  const int slot = triu_slot(__float_as_int(bj.w), __float_as_int(bk.w), p.num_species);
  const float* gp = gs + slot * gz;
  const float eta_log2e = -p.eta * 1.4426950408889634f;
  float s_f = 0.0f, s_m = 0.0f, s_c = 0.0f;
#pragma unroll
  for (int a = 0; a < kSh; ++a) {
    if (a < sh) {
      const float dr = mean - p.shift[a];
      const float ra = exp2f(eta_log2e * dr * dr);
      const float dra = -2.0f * p.eta * dr * ra;
      float gv[kSe];
      if (SE > 0 && SE % 4 == 0) {
#pragma unroll
        for (int b = 0; b < kSe; b += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(gp + a * kSe + b);
          gv[b] = g4.x;
          gv[b + 1] = g4.y;
          gv[b + 2] = g4.z;
          gv[b + 3] = g4.w;
        }
      } else {
#pragma unroll
        for (int b = 0; b < kSe; ++b) {
          gv[b] = b < se ? gp[a * se + b] : 0.0f;
        }
      }
      float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
      for (int b = 0; b < kSe; ++b) {
        t1 += gv[b] * ang[b];
        t2 += gv[b] * dang[b];
      }
      s_f += ra * t1;
      s_m += dra * t1;
      s_c += ra * t2;
    }
  }
  const float dl_dm = f * s_m;
  const float dl_dc = f * s_c;
  const float dl_df = s_f;
  const float coef = 0.95f * dl_dc * inv_den;
  v[0] = 0.5f * dl_dm + dl_df * bj.y * bk.x + (through_r ? dl_dc * (-c * bj.z) : 0.0f);
  v[1] = coef * ak.y;
  v[2] = coef * ak.z;
  v[3] = coef * ak.w;
  v[4] = 0.5f * dl_dm + dl_df * bj.x * bk.y + (through_r ? dl_dc * (-c * bk.z) : 0.0f);
  v[5] = coef * aj.y;
  v[6] = coef * aj.z;
  v[7] = coef * aj.w;
}

// K3b.  SH, SE as for K3.  A persistent grid of one wave: warp w of W takes
// atoms w, w + W, w + 2 W, ...; once its lanes are staged, the cotangent
// rows its pairs read are copied (cp.async) while it zeroes its gradient
// planes.  At most 64 registers, so 8 blocks of 4 warps fit an SM.
template <int SH, int SE>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
angular_aev_bwd_kernel(const float* __restrict__ g,        // (N, P * Z), row stride g_stride
                       long long g_stride,
                       const float* __restrict__ dist,     // (N, Ka)
                       const float* __restrict__ diff,     // (N, Ka, 3)
                       const int* __restrict__ species,    // (N, Ka), -1 masked
                       float* __restrict__ gdist,          // (N, Ka)
                       float* __restrict__ gdiff,          // (N, Ka, 3)
                       const AngularParams p) {
  extern __shared__ __align__(16) float bwd_smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nz = (SH > 0 ? SH : p.num_shifts) * (SE > 0 ? SE : p.num_sections);
  const int gz = bwd_slot_stride(nz);
  const int ka = p.ka;

  float* gs = bwd_smem + warp * bwd_warp_floats(p.num_pairs, nz, ka);
  float4* la = reinterpret_cast<float4*>(gs + round4(static_cast<size_t>(p.num_pairs) * gz));
  float4* lb = la + ka;
  int* map = reinterpret_cast<int*>(lb + ka);
  float* acc = reinterpret_cast<float*>(map + round4(ka));  // planes r, x, y, z

  const int warps = gridDim.x * kWarpsPerBlock;
  for (int atom = blockIdx.x * kWarpsPerBlock + warp; atom < p.n; atom += warps) {
    const size_t row = static_cast<size_t>(atom) * ka;
    const int nv = stage_bwd_lanes(dist, diff, species, row, lane, p, la, lb, map);
    __syncwarp();
    copy_slot_rows(g + static_cast<long long>(atom) * g_stride, lane, nv, lb, p.num_species, nz,
                   gs);
    for (int i = lane; i < 4 * ka; i += 32) {
      acc[i] = 0.0f;
    }
    cp_async_wait_all();
    __syncwarp();

    // pair q = (d - 1) nv + j of the rounds, advanced by 32 a step without a
    // division
    const int num = nv * (nv - 1) / 2;
    if (lane < num) {
      const int step_d = 32 / nv, step_j = 32 % nv;
      int d = lane / nv + 1, j = lane % nv;
      for (int q = lane; q < num; q += 32) {
        int k = j + d;
        k -= k >= nv ? nv : 0;
        float v[8];
        pair_grads<SH, SE>(j, k, la, lb, gs, gz, p, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          atomicAdd(acc + e * ka + j, v[e]);
          atomicAdd(acc + e * ka + k, v[4 + e]);
        }
        j += step_j;
        d += step_d;
        if (j >= nv) {
          j -= nv;
          ++d;
        }
      }
    }
    __syncwarp();

    for (int l = lane; l < ka; l += 32) {
      const int c = map[l];
      gdist[row + l] = c >= 0 ? acc[c] : 0.0f;
    }
    for (int i = lane; i < 3 * ka; i += 32) {
      const int c = map[i / 3];
      gdiff[row * 3 + i] = c >= 0 ? acc[(1 + i % 3) * ka + c] : 0.0f;
    }
    __syncwarp();  // every lane is done with this atom's shared memory
  }
}

// K3bb: blocks an SM (bounds its registers at 128 a thread), and the copies
// of each warp's second-order planes: pair rounds d take copy d mod 4, so
// that the (at most 4) rounds a batch of 32 pairs spans write to different
// copies and no two lanes of a batch add to one address
constexpr int kBwdBwdBlocksPerSM = 4;
constexpr int kPlaneCopies = 4;

// slot stride of K3bb's staged cotangent: Z where Z is a multiple of 4 (rows
// on 16 bytes, read 4 floats at a time), else Z + 1.  Unlike K3b's it is not
// padded: the lanes of a batch mostly read one or two slots, and the 4
// floats a row saves keep 4 blocks an SM at ANI-2x's widths
__host__ __device__ __forceinline__ int bwdbwd_slot_stride(int nz) {
  return nz % 4 == 0 ? nz : nz + 1;
}

// row stride of K3bb's per-pair tile: (X_a, Y_a) for each shift, then
// (A_b, A'_b) for each section, as float2s; 2 mod 4, so that the 32 rows
// written at once spread over the banks
__host__ __device__ __forceinline__ int bwdbwd_tile_stride(int sh, int se) {
  return (2 * (sh + se)) | 2;
}

// floats of K3bb's shared memory a warp: g (P, slot stride) | per compacted
// lane (r, x, y, z), (fc, fc', 1 / r, species), (u_r, u_x, u_y, u_z) as
// float4s | kPlaneCopies second-order planes of (r, x, y, z) float4s (Ka
// each) | J u accumulator (P, Z), whose met slots alone are used | pair tile
// (32, ts) | fc'' (Ka) | lane map (Ka) | met-slot flags (P bytes)
__host__ __device__ __forceinline__ size_t bwdbwd_warp_floats(int num_pairs, int sh, int se,
                                                              int ka) {
  const size_t nz = static_cast<size_t>(sh) * se;
  return round4(num_pairs * static_cast<size_t>(bwdbwd_slot_stride(static_cast<int>(nz)))) +
         (12 + 4 * kPlaneCopies) * static_cast<size_t>(ka) + round4(num_pairs * nz) +
         round4(32 * static_cast<size_t>(bwdbwd_tile_stride(sh, se))) + 2 * round4(ka) +
         round4((static_cast<size_t>(num_pairs) + 3) / 4);
}

// fc''(r), the derivative of `cutoff_fn`'s fc' as it stands (0 past the
// smooth cutoff's clamp)
__device__ __forceinline__ float cutoff_second(float r, float fc, float dfc,
                                               const AngularParams& p) {
  if (p.cutoff_kind == 0) {
    return -0.5f * p.pi_over_cutoff * p.pi_over_cutoff * cosf(r * p.pi_over_cutoff);
  }
  const float x = r / p.cutoff;
  const float u = 1.0f - x * x;
  const float uc = fmaxf(u, 1e-10f);
  const float t = -2.0f * x / p.cutoff;
  const float inv_uc2 = 1.0f / (uc * uc);
  return u >= 1e-10f ? dfc * t * inv_uc2 - 2.0f * fc * inv_uc2 / (p.cutoff * p.cutoff) -
                           2.0f * fc * t * t * inv_uc2 / uc
                     : 0.0f;
}

// K3bb's staging: `stage_bwd_lanes`, and each valid lane's direction
// lu[c] = (u_r, u_x, u_y, u_z) and fc''.  The species of lanes 0-31 come in
// `t0` (loaded while the warp's previous atom ran).
__device__ int stage_bwdbwd_lanes(const float* __restrict__ dist, const float* __restrict__ diff,
                                  const int* __restrict__ species,
                                  const float* __restrict__ u_dist,
                                  const float* __restrict__ u_diff, size_t row, int lane, int t0,
                                  const AngularParams& p, float4* la, float4* lb, float4* lu,
                                  float* lf, int* map) {
  int nv = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < p.ka; base += 32) {
    const int l = base + lane;
    const bool in = l < p.ka;
    const int t = base == 0 ? t0 : in ? species[row + l] : -1;
    const bool mine = t >= 0;
    const unsigned found = __ballot_sync(kFullMask, mine);
    const int c = nv + __popc(found & below);
    if (in) {
      map[l] = mine ? c : -1;
    }
    if (mine) {
      const float r = dist[row + l];
      float fc, dfc;
      cutoff_fn<true>(r, p, fc, dfc);
      la[c] = make_float4(r, diff[(row + l) * 3 + 0], diff[(row + l) * 3 + 1],
                          diff[(row + l) * 3 + 2]);
      lb[c] = make_float4(fc, dfc, 1.0f / r, __int_as_float(t));
      lu[c] = make_float4(u_dist[row + l], u_diff[(row + l) * 3 + 0], u_diff[(row + l) * 3 + 1],
                          u_diff[(row + l) * 3 + 2]);
      lf[c] = cutoff_second(r, fc, dfc, p);
    }
    nv += __popc(found);
  }
  return nv;
}

// K3bb's `copy_slot_rows`, from the atom's species alone (lanes 0-31 in
// `t0`), so that the copies start before its lanes are staged: starts
// copying the cotangent rows of the species pairs among its valid lanes
// (`gz` floats apart), flags those slots met and zeroes their rows of the
// J u accumulator
__device__ __forceinline__ void copy_met_rows(const float* __restrict__ grow,
                                              const int* __restrict__ species, size_t row,
                                              int lane, int t0, const AngularParams& p, int nz,
                                              int gz, float* gs, float* acc,
                                              unsigned char* met) {
  unsigned present = t0 >= 0 ? 1u << t0 : 0u;
  for (int l = 32 + lane; l < p.ka; l += 32) {
    const int t = species[row + l];
    present |= t >= 0 ? 1u << t : 0u;
  }
  present = __reduce_or_sync(kFullMask, present);
  for (unsigned ms = present; ms != 0; ms &= ms - 1) {
    const int s = __ffs(ms) - 1;
    for (unsigned mt = present >> s; mt != 0; mt &= mt - 1) {
      const int slot = triu_slot(s, s + __ffs(mt) - 1, p.num_species);
      if (lane == 0) {
        met[slot] = 1;
      }
      for (int i = lane; i < nz; i += 32) {
        cp_async4(gs + slot * gz + i, grow + slot * nz + i);
        acc[slot * nz + i] = 0.0f;
      }
    }
  }
}

// What pair {j, k} of slot `slot` gives K3bb: its row of the tile, trow[2a]
// = X_a = dF R_a + F dm R'_a, trow[2a + 1] = Y_a = F dc R_a, trow[2 sh + 2b]
// = A_b, trow[2 sh + 2b + 1] = A'_b (so that its share of J u at feature
// (a, b) is X_a A_b + Y_a A'_b), and in v the gradient of phi = <u, K3b's
// pair cotangents> on r, x, y, z of j (v[0..3]) and of k (v[4..7]); see
// angular_aev_bwd_bwd_reference for the formulas.  No division: base^(zeta
// - 2) is exp2 of the log2 that base^(zeta - 1) takes, both on the
// special-function unit alone (`exp2_approx`, `log2_approx`).
template <int SH, int SE>
__device__ __forceinline__ void pair_bwd_bwd(int j, int k, int slot, const float4* la,
                                             const float4* lb, const float4* lu, const float* lf,
                                             const float* gs, int gz, const AngularParams& p,
                                             float* trow, float* v) {
  constexpr int kSh = SH > 0 ? SH : kMaxShifts;
  constexpr int kSe = SE > 0 ? SE : kMaxSections;
  const int sh = SH > 0 ? SH : p.num_shifts;
  const int se = SE > 0 ? SE : p.num_sections;
  const float4 aj = la[j], ak = la[k];
  const float4 bj = lb[j], bk = lb[k];
  const float4 uj = lu[j], uk = lu[k];
  const float rr = aj.x * ak.x;
  const bool thr = rr >= 1e-10f;
  const float inv_den = thr ? bj.z * bk.z : 1e10f;
  const float c = 0.95f * (aj.y * ak.y + aj.z * ak.z + aj.w * ak.w) * inv_den;
  const float s2 = 1.0f - c * c;
  const float s2c = fmaxf(s2, 1e-20f);
  const float inv_sin = rsqrtf(s2c);
  const float sin_t = s2c * inv_sin;
  const bool inside = s2 > 1e-20f;
  const float dsin = inside ? -c * inv_sin : 0.0f;
  const float ddsin = inside ? -inv_sin * inv_sin * inv_sin : 0.0f;
  const float mean = 0.5f * (aj.x + ak.x);
  const float f = bj.x * bk.x;
  const float f_rj = bj.y * bk.x;
  const float f_rk = bj.x * bk.y;
  const float zeta_m1 = p.zeta - 1.0f;
  const float zeta_m2 = p.zeta - 2.0f;

  // the direction: du(F), du(m), du(c)
  const float urj = uj.x, urk = uk.x;
  const float qd = ak.y * uj.y + ak.z * uj.z + ak.w * uj.w + aj.y * uk.y + aj.z * uk.z +
                   aj.w * uk.w;
  const float c_rj = thr ? -c * bj.z : 0.0f;
  const float c_rk = thr ? -c * bk.z : 0.0f;
  const float d_f = f_rj * urj + f_rk * urk;
  const float d_m = 0.5f * (urj + urk);
  const float d_c = c_rj * urj + c_rk * urk + 0.95f * inv_den * qd;

  float ang[kSe], ang1[kSe], ang2[kSe];
#pragma unroll
  for (int b = 0; b < kSe; ++b) {
    ang[b] = ang1[b] = ang2[b] = 0.0f;
    if (b < se) {
      const float cs = p.cossec[b];
      const float sn = p.sinsec[b];
      const float slope = cs + sn * dsin;
      const float base = 0.5f * (1.0f + c * cs + sin_t * sn);
      const float lg = log2_approx(base);
      const float pw = zeta_m1 > 0.0f ? exp2_approx(zeta_m1 * lg) : 1.0f;
      const float pw2 = zeta_m2 != 0.0f ? exp2_approx(zeta_m2 * lg) : 1.0f;  // base^(zeta - 2)
      ang[b] = 2.0f * base * pw;
      ang1[b] = p.zeta * pw * slope;
      ang2[b] = 0.5f * p.zeta * zeta_m1 * pw2 * slope * slope + p.zeta * pw * sn * ddsin;
      *reinterpret_cast<float2*>(trow + 2 * sh + 2 * b) = make_float2(ang[b], ang1[b]);
    }
  }
  const float* gp = gs + slot * gz;
  const float eta_log2e = -p.eta * 1.4426950408889634f;
  float p0 = 0.0f, pm = 0.0f, pmm = 0.0f, pc = 0.0f, pmc = 0.0f, pcc = 0.0f;
#pragma unroll
  for (int a = 0; a < kSh; ++a) {
    if (a < sh) {
      const float dr = mean - p.shift[a];
      const float ra = exp2_approx(eta_log2e * dr * dr);
      const float ra1 = -2.0f * p.eta * dr * ra;
      const float ra2 = (4.0f * p.eta * p.eta * dr * dr - 2.0f * p.eta) * ra;
      float gv[kSe];
      if (SE > 0 && SE % 4 == 0) {
#pragma unroll
        for (int b = 0; b < kSe; b += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(gp + a * kSe + b);
          gv[b] = g4.x;
          gv[b + 1] = g4.y;
          gv[b + 2] = g4.z;
          gv[b + 3] = g4.w;
        }
      } else {
#pragma unroll
        for (int b = 0; b < kSe; ++b) {
          gv[b] = b < se ? gp[a * se + b] : 0.0f;
        }
      }
      float t1 = 0.0f, t2 = 0.0f, t3 = 0.0f;
#pragma unroll
      for (int b = 0; b < kSe; ++b) {
        t1 += gv[b] * ang[b];
        t2 += gv[b] * ang1[b];
        t3 += gv[b] * ang2[b];
      }
      p0 += ra * t1;
      pm += ra1 * t1;
      pmm += ra2 * t1;
      pc += ra * t2;
      pmc += ra1 * t2;
      pcc += ra * t3;
      *reinterpret_cast<float2*>(trow + 2 * a) = make_float2(d_f * ra + f * d_m * ra1,
                                                             f * d_c * ra);
    }
  }
  const float w_f = pm * d_m + pc * d_c;
  const float w_m = pm * d_f + f * (pmm * d_m + pmc * d_c);
  const float w_c = pc * d_f + f * (pmc * d_m + pcc * d_c);
  const float wr = thr ? urj * bj.z + urk * bk.z : 0.0f;
  const float fpc = f * pc;
  const float ddc_rj =
      thr ? c * bj.z * wr + c * urj * bj.z * bj.z - 0.95f * qd * inv_den * bj.z : 0.0f;
  const float ddc_rk =
      thr ? c * bk.z * wr + c * urk * bk.z * bk.z - 0.95f * qd * inv_den * bk.z : 0.0f;
  const float dfc_jk = bj.y * bk.y;
  v[0] = w_f * f_rj + 0.5f * w_m + w_c * c_rj + fpc * ddc_rj +
         p0 * (lf[j] * bk.x * urj + dfc_jk * urk);
  v[4] = w_f * f_rk + 0.5f * w_m + w_c * c_rk + fpc * ddc_rk +
         p0 * (dfc_jk * urj + bj.x * lf[k] * urk);
  const float alpha = 0.95f * inv_den * (w_c - fpc * wr);
  const float beta = 0.95f * inv_den * fpc;
  v[1] = alpha * ak.y + beta * uk.y;
  v[2] = alpha * ak.z + beta * uk.z;
  v[3] = alpha * ak.w + beta * uk.w;
  v[5] = alpha * aj.y + beta * uj.y;
  v[6] = alpha * aj.z + beta * uj.z;
  v[7] = alpha * aj.w + beta * uj.w;
}

// adds (v0, v1, v2, v3) to the float4 at h (shared memory, no other lane of
// the warp at the same address)
__device__ __forceinline__ void add4(float4* h, float v0, float v1, float v2, float v3) {
  float4 o = *h;
  o.x += v0;
  o.y += v1;
  o.z += v2;
  o.w += v3;
  *h = o;
}

// K3bb.  SH, SE as for K3.  A persistent grid of one wave, as K3b's (at most
// 128 registers, 4 blocks of 4 warps an SM); warp w of W takes atoms w, w +
// W, ...  Per atom: the valid lanes, the direction and the cotangent rows
// its pairs read are staged as in K3b; its pairs, 32 at a time in K3b's
// rounds (no division: a lane's round and lane advance by 32 pairs a step),
// are first ordered by slot (a ballot per slot in the batch: segment e
// holds one slot's pairs), then each computes its tile row at its place and
// adds its second-order values to the planes of its round's copy with plain
// shared loads and stores; then each lane sums its own features' share of
// J u over each segment's rows into that slot's accumulator row.  gg is
// written 16 bytes a lane: the met slots from the accumulator, the others
// as zeros from registers.
template <int SH, int SE>
__global__ void __launch_bounds__(kThreads, kBwdBwdBlocksPerSM)
angular_aev_bwd_bwd_kernel(const float* __restrict__ g,        // (N, P * Z), row stride g_stride
                           long long g_stride,
                           const float* __restrict__ dist,     // (N, Ka)
                           const float* __restrict__ diff,     // (N, Ka, 3)
                           const int* __restrict__ species,    // (N, Ka), -1 masked
                           const float* __restrict__ u_dist,   // (N, Ka)
                           const float* __restrict__ u_diff,   // (N, Ka, 3)
                           float* __restrict__ gg,             // (N, P * Z)
                           float* __restrict__ hdist,          // (N, Ka)
                           float* __restrict__ hdiff,          // (N, Ka, 3)
                           const AngularParams p) {
  constexpr int kSh = SH > 0 ? SH : kMaxShifts;
  constexpr int kSe = SE > 0 ? SE : kMaxSections;
  constexpr bool kVec = SE > 0 && (SH * SE) % 4 == 0;  // gg rows written as float4s
  extern __shared__ __align__(16) float bb_smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const int sh = SH > 0 ? SH : p.num_shifts;
  const int se = SE > 0 ? SE : p.num_sections;
  const int nz = sh * se;
  const int pz = p.num_pairs * nz;
  const int gz = bwdbwd_slot_stride(nz);
  const int ka = p.ka;
  const int ts = bwdbwd_tile_stride(sh, se);

  float* gs = bb_smem + warp * bwdbwd_warp_floats(p.num_pairs, sh, se, ka);
  float4* la = reinterpret_cast<float4*>(gs + round4(static_cast<size_t>(p.num_pairs) * gz));
  float4* lb = la + ka;
  float4* lu = lb + ka;
  float4* hacc = lu + ka;  // kPlaneCopies planes of Ka (r, x, y, z)
  float* acc = reinterpret_cast<float*>(hacc + kPlaneCopies * ka);
  float* tile = acc + round4(static_cast<size_t>(pz));
  float* lf = tile + round4(32 * static_cast<size_t>(ts));
  int* map = reinterpret_cast<int*>(lf + round4(ka));
  unsigned char* met = reinterpret_cast<unsigned char*>(map + round4(ka));

  // this lane's features z = lane + 32 i: (X_a, Y_a) and (A_b, A'_b) at
  // these tile columns
  constexpr int kZPerLane = (kSh * kSe + 31) / 32;
  int col_x[kZPerLane], col_a[kZPerLane];
#pragma unroll
  for (int i = 0; i < kZPerLane; ++i) {
    const int z = lane + 32 * i;
    col_x[i] = z < nz ? 2 * (z / se) : 0;
    col_a[i] = z < nz ? 2 * sh + 2 * (z % se) : 0;
  }

  const int warps = gridDim.x * kWarpsPerBlock;
  int atom = blockIdx.x * kWarpsPerBlock + warp;
  // the species of the warp's next atom, lanes 0-31, loaded one atom ahead
  int t_next = atom < p.n && lane < ka ? species[static_cast<size_t>(atom) * ka + lane] : -1;
  for (; atom < p.n; atom += warps) {
    const size_t row = static_cast<size_t>(atom) * ka;
    const int t0 = t_next;
    const size_t next_row = static_cast<size_t>(atom + warps) * ka;
    t_next = atom + warps < p.n && lane < ka ? species[next_row + lane] : -1;
    for (int i = lane; i < p.num_pairs; i += 32) {
      met[i] = 0;
    }
    __syncwarp();
    copy_met_rows(g + static_cast<long long>(atom) * g_stride, species, row, lane, t0, p, nz,
                  gz, gs, acc, met);
    for (int i = lane; i < kPlaneCopies * ka; i += 32) {
      hacc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    const int nv = stage_bwdbwd_lanes(dist, diff, species, u_dist, u_diff, row, lane, t0, p, la,
                                      lb, lu, lf, map);
    cp_async_wait_all();
    __syncwarp();

    const int num = nv * (nv - 1) / 2;
    if (num > 0) {
      // pair q = (d - 1) nv + j of the rounds: k = (j + d) mod nv
      const int step_d = 32 / nv, step_j = 32 % nv;
      int d = lane / nv + 1, j = lane % nv;
      for (int q0 = 0; q0 < num; q0 += 32) {
        const bool on = q0 + lane < num;
        int k = j + d;
        k -= k >= nv ? nv : 0;
        const int slot = on ? triu_slot(__float_as_int(lb[j].w), __float_as_int(lb[k].w),
                                        p.num_species)
                            : -1;
        // the batch's pairs ordered by slot: segment e (held by lane e) is
        // one slot's rows [end of e - 1, seg_end) of the tile
        unsigned left = __ballot_sync(kFullMask, on);
        int place = 0, filled = 0, segs = 0, seg_slot = 0, seg_end = 0;
        while (left != 0) {
          const int s = __shfl_sync(kFullMask, slot, __ffs(left) - 1);
          const unsigned same = __ballot_sync(kFullMask, slot == s);
          if (slot == s) {
            place = filled + __popc(same & below);
          }
          filled += __popc(same);
          if (lane == segs) {
            seg_slot = s;
            seg_end = filled;
          }
          ++segs;
          left &= ~same;
        }
        float v[8];
        float4* h = hacc + (d % kPlaneCopies) * ka;
        if (on) {
          pair_bwd_bwd<SH, SE>(j, k, slot, la, lb, lu, lf, gs, gz, p, tile + place * ts, v);
          add4(h + j, v[0], v[1], v[2], v[3]);
        }
        __syncwarp();
        if (on) {
          add4(h + k, v[4], v[5], v[6], v[7]);
        }
        __syncwarp();
        int start = 0;
        for (int e = 0; e < segs; ++e) {
          const int s = __shfl_sync(kFullMask, seg_slot, e);
          const int end = __shfl_sync(kFullMask, seg_end, e);
#pragma unroll
          for (int i = 0; i < kZPerLane; ++i) {
            if (lane + 32 * i < nz) {
              float r0 = 0.0f, r1 = 0.0f;
#pragma unroll 4
              for (int m = start; m < end; ++m) {
                const float* t = tile + m * ts;
                const float2 xy = *reinterpret_cast<const float2*>(t + col_x[i]);
                const float2 aa = *reinterpret_cast<const float2*>(t + col_a[i]);
                r0 = fmaf(xy.x, aa.x, r0);
                r1 = fmaf(xy.y, aa.y, r1);
              }
              acc[s * nz + lane + 32 * i] += r0 + r1;
            }
          }
          start = end;
        }
        __syncwarp();
        j += step_j;
        d += step_d;
        if (j >= nv) {
          j -= nv;
          ++d;
        }
      }
    }

    // gg: the met slots' accumulator rows, zeros elsewhere
    float* o = gg + static_cast<size_t>(atom) * pz;
    if (kVec) {
      constexpr int kQ = kVec ? SH * SE / 4 : 1;  // float4s a slot
      for (int i = lane; i < pz / 4; i += 32) {
        reinterpret_cast<float4*>(o)[i] = met[i / kQ]
                                              ? reinterpret_cast<const float4*>(acc)[i]
                                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      for (int i = lane; i < pz; i += 32) {
        o[i] = met[i / nz] ? acc[i] : 0.0f;
      }
    }
    for (int l = lane; l < ka; l += 32) {
      const int c = map[l];
      float sum = 0.0f;
      if (c >= 0) {
#pragma unroll
        for (int cp = 0; cp < kPlaneCopies; ++cp) {
          sum += hacc[cp * ka + c].x;
        }
      }
      hdist[row + l] = sum;
    }
    for (int i = lane; i < 3 * ka; i += 32) {
      const int c = map[i / 3];
      float sum = 0.0f;
      if (c >= 0) {
#pragma unroll
        for (int cp = 0; cp < kPlaneCopies; ++cp) {
          sum += reinterpret_cast<const float*>(hacc + cp * ka + c)[1 + i % 3];
        }
      }
      hdiff[row * 3 + i] = sum;
    }
    __syncwarp();  // every lane is done with this atom's shared memory
  }
}

using FwdKernel = void (*)(const float*, const float*, const int*, float*, AngularParams);
using BwdKernel = void (*)(const float*, long long, const float*, const float*, const int*,
                           float*, float*, AngularParams);

FwdKernel pick_fwd(int sh, int se) {
  if (sh == 8 && se == 4) {
    return angular_aev_kernel<8, 4>;
  }
  if (sh == 4 && se == 8) {
    return angular_aev_kernel<4, 8>;
  }
  return angular_aev_kernel<0, 0>;
}

using BwdBwdKernel = void (*)(const float*, long long, const float*, const float*, const int*,
                              const float*, const float*, float*, float*, float*, AngularParams);

BwdBwdKernel pick_bwd_bwd(int sh, int se) {
  if (sh == 8 && se == 4) {
    return angular_aev_bwd_bwd_kernel<8, 4>;
  }
  if (sh == 4 && se == 8) {
    return angular_aev_bwd_bwd_kernel<4, 8>;
  }
  return angular_aev_bwd_bwd_kernel<0, 0>;
}

BwdKernel pick_bwd(int sh, int se) {
  if (sh == 8 && se == 4) {
    return angular_aev_bwd_kernel<8, 4>;
  }
  if (sh == 4 && se == 8) {
    return angular_aev_bwd_kernel<4, 8>;
  }
  return angular_aev_bwd_kernel<0, 0>;
}

// Fills `p` from the host arguments; cudaErrorInvalidValue for widths the
// kernels do not take.
cudaError_t make_params(AngularParams& p, int n, int ka, int num_species, const float* shifts,
                        int num_shifts, const float* cos_sections, const float* sin_sections,
                        int num_sections, float eta, float zeta, float cutoff,
                        float pi_over_cutoff, int cutoff_kind) {
  if (n <= 0 || ka <= 0 || num_species <= 0 || num_species > 32 || num_shifts <= 0 ||
      num_shifts > kMaxShifts || num_sections <= 0 || num_sections > kMaxSections) {
    return cudaErrorInvalidValue;
  }
  for (int a = 0; a < kMaxShifts; ++a) {
    p.shift[a] = a < num_shifts ? shifts[a] : 0.0f;
  }
  for (int b = 0; b < kMaxSections; ++b) {
    p.cossec[b] = b < num_sections ? cos_sections[b] : 0.0f;
    p.sinsec[b] = b < num_sections ? sin_sections[b] : 0.0f;
  }
  p.n = n;
  p.ka = ka;
  p.num_species = num_species;
  p.num_pairs = num_species * (num_species + 1) / 2;
  p.num_shifts = num_shifts;
  p.num_sections = num_sections;
  p.eta = eta;
  p.zeta = zeta;
  p.cutoff = cutoff;
  p.pi_over_cutoff = pi_over_cutoff;
  p.cutoff_kind = cutoff_kind;
  return cudaSuccess;
}

// Raises the kernel's dynamic shared memory limit past the 48 KB default
// where it needs more; cudaErrorInvalidValue past the card's 227 KB.
cudaError_t allow_shared(const void* kernel, size_t smem) {
  if (smem > kMaxSharedBytes) {
    return cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

// A persistent grid of one wave for `kernel` with `smem` bytes of shared
// memory a block: as many blocks as the card holds at once (from the
// kernel's registers and shared memory), no more than the atoms need;
// raises the kernel's shared memory limit on the way
cudaError_t persistent_shape(const void* kernel, size_t smem, int n, int device, int& blocks) {
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) {
    return err;
  }
  int per_sm = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess) {
    return err;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return err;
  }
  if (per_sm == 0) {
    return cudaErrorInvalidConfiguration;  // not one block fits an SM
  }
  blocks = std::min((n + kWarpsPerBlock - 1) / kWarpsPerBlock, per_sm * sms);
  return cudaSuccess;
}

// K3b's persistent grid
cudaError_t bwd_shape(BwdKernel kernel, const AngularParams& p, int device, int& blocks,
                      size_t& smem) {
  smem = kWarpsPerBlock * sizeof(float) *
         bwd_warp_floats(p.num_pairs, p.num_shifts * p.num_sections, p.ka);
  return persistent_shape(reinterpret_cast<const void*>(kernel), smem, p.n, device, blocks);
}

// K3bb's persistent grid
cudaError_t bwd_bwd_shape(BwdBwdKernel kernel, const AngularParams& p, int device, int& blocks,
                          size_t& smem) {
  smem = kWarpsPerBlock * sizeof(float) *
         bwdbwd_warp_floats(p.num_pairs, p.num_shifts, p.num_sections, p.ka);
  return persistent_shape(reinterpret_cast<const void*>(kernel), smem, p.n, device, blocks);
}

}  // namespace

extern "C" {

// All three launch on `stream` (a cudaStream_t) of `device` and return the
// cudaError_t of the launch (0 on success).  `dist`, `diff`, `species` and
// the outputs are contiguous device arrays; `g` is a device array whose rows
// are `g_row_stride` floats apart, its columns contiguous.  `shifts`,
// `cos_sections` and `sin_sections` are host arrays.

int angular_aev_launch(const float* dist, const float* diff, const int* species, float* out,
                       int n, int ka, int num_species, const float* shifts, int num_shifts,
                       const float* cos_sections, const float* sin_sections, int num_sections,
                       float eta, float zeta, float cutoff, float pi_over_cutoff,
                       int cutoff_kind, int device, void* stream) {
  AngularParams p;
  cudaError_t err = make_params(p, n, ka, num_species, shifts, num_shifts, cos_sections,
                                sin_sections, num_sections, eta, zeta, cutoff, pi_over_cutoff,
                                cutoff_kind);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int nz = num_shifts * num_sections;
  const size_t smem = kWarpsPerBlock * sizeof(float) *
                      fwd_warp_floats(p.num_pairs, nz, tile_stride(num_shifts, num_sections), ka);
  const FwdKernel kernel = pick_fwd(num_shifts, num_sections);
  if ((err = allow_shared(reinterpret_cast<const void*>(kernel), smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(dist, diff, species,
                                                                         out, p);
  return static_cast<int>(cudaGetLastError());
}

int angular_aev_bwd_launch(const float* g, long long g_row_stride, const float* dist,
                           const float* diff, const int* species, float* gdist, float* gdiff,
                           int n, int ka, int num_species, const float* shifts, int num_shifts,
                           const float* cos_sections, const float* sin_sections,
                           int num_sections, float eta, float zeta, float cutoff,
                           float pi_over_cutoff, int cutoff_kind, int device, void* stream) {
  AngularParams p;
  cudaError_t err = make_params(p, n, ka, num_species, shifts, num_shifts, cos_sections,
                                sin_sections, num_sections, eta, zeta, cutoff, pi_over_cutoff,
                                cutoff_kind);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (g_row_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  int blocks = 0;
  size_t smem = 0;
  const BwdKernel kernel = pick_bwd(num_shifts, num_sections);
  if ((err = bwd_shape(kernel, p, device, blocks, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g, g_row_stride, dist, diff, species, gdist, gdiff, p);
  return static_cast<int>(cudaGetLastError());
}

// K3bb: `g` read as K3b reads it; `u_dist` (N, Ka) and `u_diff` (N, Ka, 3)
// the cotangents of K3b's outputs; writes gg (N, P * Z), hdist, hdiff
int angular_aev_bwd_bwd_launch(const float* g, long long g_row_stride, const float* dist,
                               const float* diff, const int* species, const float* u_dist,
                               const float* u_diff, float* gg, float* hdist, float* hdiff, int n,
                               int ka, int num_species, const float* shifts, int num_shifts,
                               const float* cos_sections, const float* sin_sections,
                               int num_sections, float eta, float zeta, float cutoff,
                               float pi_over_cutoff, int cutoff_kind, int device, void* stream) {
  AngularParams p;
  cudaError_t err = make_params(p, n, ka, num_species, shifts, num_shifts, cos_sections,
                                sin_sections, num_sections, eta, zeta, cutoff, pi_over_cutoff,
                                cutoff_kind);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (g_row_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  int blocks = 0;
  size_t smem = 0;
  const BwdBwdKernel kernel = pick_bwd_bwd(num_shifts, num_sections);
  if ((err = bwd_bwd_shape(kernel, p, device, blocks, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g, g_row_stride, dist, diff, species, u_dist, u_diff, gg, hdist, hdiff, p);
  return static_cast<int>(cudaGetLastError());
}

// K3b's (second_order 0) or K3bb's (1) persistent grid for these widths on
// `device`, without launching: blocks, threads a block and shared memory a
// block
int angular_aev_bwd_shape(int n, int ka, int num_species, int num_shifts, int num_sections,
                          int second_order, int device, int* blocks, int* threads,
                          long long* smem_bytes) {
  AngularParams p;
  const float zeros[kMaxShifts > kMaxSections ? kMaxShifts : kMaxSections] = {};
  cudaError_t err = make_params(p, n, ka, num_species, zeros, num_shifts, zeros, zeros,
                                num_sections, 0.0f, 1.0f, 1.0f, 1.0f, 0);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  size_t smem = 0;
  err = second_order
            ? bwd_bwd_shape(pick_bwd_bwd(num_shifts, num_sections), p, device, *blocks, smem)
            : bwd_shape(pick_bwd(num_shifts, num_sections), p, device, *blocks, smem);
  *threads = kThreads;
  *smem_bytes = static_cast<long long>(smem);
  return static_cast<int>(err);
}

const char* angular_aev_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
