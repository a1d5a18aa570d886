// K2 and K5: Jacobi collision narrow phase of targets against sources, f32.
//
// K2 replaces the TPU kernel nbodysim_tpu/kernels/collide.py:_collide_kernel
// (wrapper allpairs_collision_deltas): every particle against every
// particle, sources = targets. K5 replaces _rect_kernel (wrapper
// rect_pair_deltas): n targets against a separate set of s sources, the
// exact big-body and overflow-residual passes of the large-N broad phases,
// with two more masks: the target's mass > 0, and optionally the Chebyshev
// distance of the int32 cell coordinates <= max_cheb. Both are one kernel,
// instantiated with and without those masks. The pair math is
// collide_pair.cuh, shared with K6. Target side only; zero-mass sources
// never overlap.
//
// What bounds it on the H100: the overlap test, ~8 f32 ops per pair, since
// overlaps are rare (~1e-3 of pairs on the disc); the resolve branch costs
// ~4x the test but runs only for overlapping pairs. Measured on an NVIDIA
// H100 80GB HBM3 at a 700 W power limit: 1.31e12 pairs/s on the N=25k disc
// (where no pair overlaps), below K1: each pair reads two float4 from shared
// memory and builds d^2 without FMA. Design: the skeleton of K1 (64 targets
// x 4 source slices per block, sources staged through shared memory as two
// float4 per source: x, y, z, m and vx, vy, vz, r, plus an int4 of cell
// coordinates when the cell mask is on). A per-pair branch takes the place
// of the TPU kernel's per-tile skip; a warp pays for it only when one of its
// 32 targets overlaps the source in hand. The TPU wrapper's cell sort is not
// done (a per-pair branch does not need it; see PERF.md), nor K5's packed
// [N, 16] IO or its float compare of cells: cells are compared as int32.
//
// Few targets, many sources (K5's big-body pass, 64 x N): the caller splits
// the sources into `splits` contiguous chunks along gridDim.y, as K1 does;
// each chunk writes its partial sums to scratch, and nb_sum_splits
// (allpairs.cu) adds them in chunk order, so the result stays deterministic.
//
// Outputs: `out` holds [2, n, D]: dpos, then dvel (with splits > 1, one such
// pair per chunk in the scratch array).

#include <cuda_runtime.h>

#include "collide_pair.cuh"

extern "C" int nb_sum_splits(const float* part, float* out, int count,
                             int splits, void* stream);

namespace {

using nb_collide::abs_wrap;
using nb_collide::collide_pair;
using nb_collide::sub_wrap;

constexpr int kTargets = 64;
constexpr int kSlices = 4;
constexpr int kTile = kTargets * kSlices;

// RECT: separate sources and the target-mass mask (K5); CHEB: the cell mask.
template <int DIM, bool RECT, bool CHEB>
__global__ void __launch_bounds__(kTile)
collide_kernel(const float* __restrict__ tpos, const float* __restrict__ tvel,
               const float* __restrict__ tmass,
               const float* __restrict__ trad, const int* __restrict__ tcell,
               const float* __restrict__ spos, const float* __restrict__ svel,
               const float* __restrict__ smass,
               const float* __restrict__ srad, const int* __restrict__ scell,
               float* __restrict__ out, int n, int s, int chunk,
               int max_cheb, float impulse) {
  __shared__ float4 tile_p[kTile];  // x, y, z, m
  __shared__ float4 tile_v[kTile];  // vx, vy, vz, r
  __shared__ int4 tile_c[CHEB ? kTile : 1];
  __shared__ float part[kSlices - 1][2 * DIM][kTargets];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int lane = ty * kTargets + tx;
  const int i = blockIdx.x * kTargets + tx;

  float pi[DIM], vi[DIM], mi = 0.f, ri = 0.f;
  int ci[3] = {0, 0, 0};
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    pi[c] = i < n ? tpos[i * DIM + c] : 0.f;
    vi[c] = i < n ? tvel[i * DIM + c] : 0.f;
    if (CHEB) ci[c] = i < n ? tcell[i * DIM + c] : 0;
  }
  if (i < n) {
    mi = tmass[i];
    ri = trad[i];
  }
  const bool active = i < n && (!RECT || mi > 0.f);
  float acc_p[DIM], acc_v[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) acc_p[c] = acc_v[c] = 0.f;

  // This block's chunk of sources: [s_begin, s_end), chunk a multiple of
  // kTile; blockIdx.y == 0 and chunk >= s without a split.
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(s, s_begin + chunk);
  for (int base = s_begin; base < s_end; base += kTile) {
    const int j = base + lane;
    if (j < s_end) {
      float4 p, v;
      p.x = spos[j * DIM];
      p.y = spos[j * DIM + 1];
      p.z = DIM == 3 ? spos[j * DIM + 2] : 0.f;
      p.w = smass[j];
      v.x = svel[j * DIM];
      v.y = svel[j * DIM + 1];
      v.z = DIM == 3 ? svel[j * DIM + 2] : 0.f;
      v.w = srad[j];
      tile_p[lane] = p;
      tile_v[lane] = v;
      if (CHEB) {
        tile_c[lane] = make_int4(scell[j * DIM], scell[j * DIM + 1],
                                 DIM == 3 ? scell[j * DIM + 2] : 0, 0);
      }
    }
    __syncthreads();
    const int count = min(kTargets, s_end - base - ty * kTargets);
    const int first = ty * kTargets;
    if (active) {
      for (int k = 0; k < count; ++k) {
        const float4 p = tile_p[first + k];
        if (CHEB) {
          const int4 q = tile_c[first + k];
          const int sc[3] = {q.x, q.y, q.z};
          int cheb = 0;
#pragma unroll
          for (int c = 0; c < DIM; ++c)
            cheb = max(cheb, abs_wrap(sub_wrap(sc[c], ci[c])));
          if (cheb > max_cheb) continue;
        }
        const float4 q = tile_v[first + k];
        const float sp[3] = {p.x, p.y, p.z};
        const float sv[3] = {q.x, q.y, q.z};
        collide_pair<DIM>(pi, vi, mi, ri, sp, sv, p.w, q.w, impulse, acc_p,
                          acc_v);
      }
    }
    __syncthreads();
  }

  if (ty > 0) {
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      part[ty - 1][c][tx] = acc_p[c];
      part[ty - 1][DIM + c][tx] = acc_v[c];
    }
  }
  __syncthreads();
  if (ty == 0 && i < n) {
#pragma unroll
    for (int sl = 0; sl < kSlices - 1; ++sl) {
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        acc_p[c] += part[sl][c][tx];
        acc_v[c] += part[sl][DIM + c][tx];
      }
    }
    float* dpos = out + static_cast<size_t>(blockIdx.y) * 2 * n * DIM;
    float* dvel = dpos + static_cast<size_t>(n) * DIM;
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      dpos[i * DIM + c] = acc_p[c];
      dvel[i * DIM + c] = acc_v[c];
    }
  }
}

template <int DIM, bool RECT, bool CHEB>
void launch(const float* tpos, const float* tvel, const float* tmass,
            const float* trad, const int* tcell, const float* spos,
            const float* svel, const float* smass, const float* srad,
            const int* scell, float* out, int n, int s, int splits,
            int chunk, int max_cheb, float impulse, cudaStream_t stream) {
  const dim3 block(kTargets, kSlices);
  const dim3 grid((n + kTargets - 1) / kTargets, splits);
  collide_kernel<DIM, RECT, CHEB><<<grid, block, 0, stream>>>(
      tpos, tvel, tmass, trad, tcell, spos, svel, smass, srad, scell, out, n,
      s, chunk, max_cheb, impulse);
}

template <int DIM>
void launch_rect(const float* tpos, const float* tvel, const float* tmass,
                 const float* trad, const int* tcell, const float* spos,
                 const float* svel, const float* smass, const float* srad,
                 const int* scell, float* out, int n, int s, int splits,
                 int chunk, int max_cheb, float impulse, cudaStream_t st) {
  if (max_cheb >= 0) {
    launch<DIM, true, true>(tpos, tvel, tmass, trad, tcell, spos, svel, smass,
                            srad, scell, out, n, s, splits, chunk, max_cheb,
                            impulse, st);
  } else {
    launch<DIM, true, false>(tpos, tvel, tmass, trad, tcell, spos, svel,
                             smass, srad, scell, out, n, s, splits, chunk, 0,
                             impulse, st);
  }
}

}  // namespace

// K2: out [2, n, dim] = (dpos, dvel) of every particle against all of them.
extern "C" int nb_collision_deltas(
    const float* pos, const float* vel, const float* mass,
    const float* radius, float* out, int n, int dim, float impulse,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dim == 2) {
    launch<2, false, false>(pos, vel, mass, radius, nullptr, pos, vel, mass,
                            radius, nullptr, out, n, n, 1, n, 0, impulse, st);
  } else if (dim == 3) {
    launch<3, false, false>(pos, vel, mass, radius, nullptr, pos, vel, mass,
                            radius, nullptr, out, n, n, 1, n, 0, impulse, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: out [2, n, dim] = target-side (dpos, dvel) of n targets against s
// sources; max_cheb < 0 turns the cell mask off (the cell pointers may then
// be null). splits >= 1 source chunks; with splits > 1, `scratch` holds
// splits * 2 * n * dim floats.
extern "C" int nb_rect_pair_deltas(
    const float* tpos, const float* tvel, const float* tmass,
    const float* trad, const int* tcell, const float* spos, const float* svel,
    const float* smass, const float* srad, const int* scell, float* out,
    float* scratch, int n, int s, int dim, int splits, int max_cheb,
    float impulse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || s <= 0 || splits <= 0 || (splits > 1 && scratch == nullptr) ||
      (max_cheb >= 0 && (tcell == nullptr || scell == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // Chunks are whole tiles, so only the last one is ragged.
  const int per = (s + splits - 1) / splits;
  const int chunk = (per + kTile - 1) / kTile * kTile;
  float* dst = splits > 1 ? scratch : out;
  if (dim == 2) {
    launch_rect<2>(tpos, tvel, tmass, trad, tcell, spos, svel, smass, srad,
                   scell, dst, n, s, splits, chunk, max_cheb, impulse, st);
  } else if (dim == 3) {
    launch_rect<3>(tpos, tvel, tmass, trad, tcell, spos, svel, smass, srad,
                   scell, dst, n, s, splits, chunk, max_cheb, impulse, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return nb_sum_splits(scratch, out, 2 * n * dim, splits, stream);
}
