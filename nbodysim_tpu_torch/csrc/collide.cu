// K2 and K5: Jacobi collision narrow phase of targets against sources, f32.
//
// K2 replaces the TPU kernel nbodysim_tpu/kernels/collide.py:_collide_kernel
// (wrapper allpairs_collision_deltas): every particle against every
// particle, sources = targets, or a target row range of them against all. K5 replaces _rect_kernel (wrapper
// rect_pair_deltas): n targets against a separate set of s sources, the
// exact big-body and overflow-residual passes of the large-N broad phases,
// with two more masks: the target's mass > 0, and optionally the Chebyshev
// distance of the int32 cell coordinates <= max_cheb. Both are one kernel,
// instantiated with and without those masks. The pair math is
// collide_pair.cuh, shared with K6. Target side only; zero-mass sources
// never overlap.
//
// What bounds it on the H100: the overlap test, since overlaps are rare
// (none on the N=25k disc in 205 steps). In explicitly rounded f32, so that
// decisions match the plain version bit for bit, a 2D test is 2 FADD, 2 FMUL
// and an FADD for d^2, an FADD and an FMUL for (r_i + r_j)^2 and one FSETP
// that folds the result into the target's predicate, plus half an LDS.128:
// ~8.5 issue slots (chip_smoke.py prints the SASS count of a batch), ~12 in
// 3D; K5's cell test is as many integer instructions. Measured on an NVIDIA
// H100 80GB HBM3 at a 700 W power limit: N=25k in 0.237 ms (2.6e12
// pairs/s), N=65,536 in 1.52 ms; K5 at [1M x 16384] with the cell mask in
// 6.70 ms. The kernel it replaced (two LDS.128, a loop that was not
// unrolled and a branch into the resolve path on every pair) ran at
// 1.31e12 pairs/s.
//
// Design, K1's skeleton:
//  * 2 targets a thread (4 took 126-226 registers and ran slower at every
//    shape measured), 8 warps a block, warp w
//    walks slice w of every staged tile; slice sums added in a fixed order.
//  * Sources packed as they are staged, 256 to a tile, double-buffered
//    through registers with one barrier a tile: float4 (x, y, z, r) for the
//    test, where r is NaN for a source of mass <= 0 (r_i + NaN fails
//    d^2 <= r^2, which is exactly the plain version's `valid = m_j > 0`),
//    and float4 (vx, vy, vz, m), read only by the resolve path. Targets that
//    are out of range, or of mass <= 0 under K5, carry a NaN radius too.
//    Padding sources sit at 1e18 with a NaN radius. With the cell mask, an
//    int4 of cells a source.
//  * The test runs over a batch of 16 sources with no branch, ORing each
//    target's hits into one predicate (with the cell mask, the batch test
//    is the cell test alone: it is the rarer one on K5's residual shape).
//    A thread branches into the resolve path once a batch, only for the
//    targets whose predicate is set, and there collide_pair repeats the
//    exact test pair by pair: the TPU kernel's per-tile skip at thread
//    granularity. The sum order within a slice is the source order.
//  * d^2, r and r^2 keep __fsub_rn/__fmul_rn/__fadd_rn in the plain
//    version's column order, so overlap and separating/approaching
//    decisions are those of collision_deltas_plain.
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

constexpr int kWarp = 32;
constexpr int kSlices = 8;                  // warps a block, one slice each
constexpr int kThreads = kWarp * kSlices;   // 256
constexpr int kTile = kThreads;             // sources staged per pass, 1 a thread
constexpr int kPerSlice = kTile / kSlices;  // 32
constexpr int kBatch = 16;                  // sources a branch-free test
constexpr int K = 2;                        // targets a thread
constexpr int kBlockTargets = kWarp * K;
constexpr float kPadPos = 1e18f;
constexpr int kPadCell = 1 << 30;

struct Staged {
  float4 p, v;
  int4 c;
};

// Source j as staged: (x, y, z, r or NaN), (vx, vy, vz, m), cells.
template <int DIM, bool CHEB>
__device__ __forceinline__ Staged stage_source(
    const float* __restrict__ spos, const float* __restrict__ svel,
    const float* __restrict__ smass, const float* __restrict__ srad,
    const int* __restrict__ scell, int j, int end) {
  Staged st;
  if (j >= end) {
    st.p = make_float4(kPadPos, kPadPos, kPadPos, __int_as_float(0x7fc00000));
    st.v = make_float4(0.f, 0.f, 0.f, 0.f);
    st.c = make_int4(kPadCell, kPadCell, kPadCell, 0);
    return st;
  }
  const float m = smass[j];
  st.p.x = spos[j * DIM];
  st.p.y = spos[j * DIM + 1];
  st.p.z = DIM == 3 ? spos[j * DIM + 2] : 0.f;
  st.p.w = m > 0.f ? srad[j] : __int_as_float(0x7fc00000);
  st.v.x = svel[j * DIM];
  st.v.y = svel[j * DIM + 1];
  st.v.z = DIM == 3 ? svel[j * DIM + 2] : 0.f;
  st.v.w = m;
  if (CHEB)
    st.c = make_int4(scell[j * DIM], scell[j * DIM + 1],
                     DIM == 3 ? scell[j * DIM + 2] : 0, 0);
  return st;
}

template <int DIM>
__device__ __forceinline__ int cheb_dist(const int* ci, int4 q) {
  const int sc[3] = {q.x, q.y, q.z};
  int cheb = 0;
#pragma unroll
  for (int c = 0; c < DIM; ++c)
    cheb = max(cheb, abs_wrap(sub_wrap(sc[c], ci[c])));
  return cheb;
}

// RECT: separate sources and the target-mass mask (K5); CHEB: the cell mask.
template <int DIM, bool RECT, bool CHEB>
__global__ void __launch_bounds__(kThreads)
collide_kernel(const float* __restrict__ tpos, const float* __restrict__ tvel,
               const float* __restrict__ tmass,
               const float* __restrict__ trad, const int* __restrict__ tcell,
               const float* __restrict__ spos, const float* __restrict__ svel,
               const float* __restrict__ smass,
               const float* __restrict__ srad, const int* __restrict__ scell,
               float* __restrict__ out, int n, int s, int chunk,
               int max_cheb, float impulse) {
  __shared__ float4 tile_p[2][kTile];
  __shared__ float4 tile_v[2][kTile];
  __shared__ int4 tile_c[CHEB ? 2 : 1][CHEB ? kTile : 1];
  __shared__ float part[kSlices - 1][2 * DIM][kBlockTargets];

  const int lane = threadIdx.x % kWarp;
  const int slice = threadIdx.x / kWarp;
  const int first = blockIdx.x * kBlockTargets + lane;

  float pi[K][DIM], vi[K][DIM], mi[K], ri[K];
  int ci[K][3];
  float acc_p[K][DIM], acc_v[K][DIM];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = first + kWarp * k;
    const bool in = i < n;
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      pi[k][c] = in ? tpos[i * DIM + c] : 0.f;
      vi[k][c] = in ? tvel[i * DIM + c] : 0.f;
      ci[k][c] = CHEB && in ? tcell[i * DIM + c] : 0;
      acc_p[k][c] = acc_v[k][c] = 0.f;
    }
    mi[k] = in ? tmass[i] : 0.f;
    // An inactive target never overlaps: its radius is NaN.
    const bool active = in && (!RECT || mi[k] > 0.f);
    ri[k] = active ? trad[i] : __int_as_float(0x7fc00000);
  }

  // This block's chunk of sources: [s_begin, s_end), chunk a multiple of
  // kTile; blockIdx.y == 0 and chunk >= s without a split.
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(s, s_begin + chunk);
  const int tiles = s_end > s_begin ? (s_end - s_begin + kTile - 1) / kTile
                                    : 0;
  if (tiles > 0) {
    const Staged st = stage_source<DIM, CHEB>(
        spos, svel, smass, srad, scell, s_begin + threadIdx.x, s_end);
    tile_p[0][threadIdx.x] = st.p;
    tile_v[0][threadIdx.x] = st.v;
    if (CHEB) tile_c[0][threadIdx.x] = st.c;
  }
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const bool more = t + 1 < tiles;
    Staged next;
    if (more)  // tile t+1 into registers; its loads fly during tile t
      next = stage_source<DIM, CHEB>(spos, svel, smass, srad, scell,
                                     s_begin + (t + 1) * kTile + threadIdx.x,
                                     s_end);
    const int buf = t & 1;
    const int base = slice * kPerSlice;
#pragma unroll 1
    for (int b0 = base; b0 < base + kPerSlice; b0 += kBatch) {
      bool hit[K];
#pragma unroll
      for (int k = 0; k < K; ++k) hit[k] = false;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (CHEB) {
          const int4 q = tile_c[buf][b0 + b];
#pragma unroll
          for (int k = 0; k < K; ++k)
            hit[k] |= cheb_dist<DIM>(ci[k], q) <= max_cheb;
        } else {
          const float4 q = tile_p[buf][b0 + b];
          const float sp[3] = {q.x, q.y, q.z};
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float d[DIM];
#pragma unroll
            for (int c = 0; c < DIM; ++c) d[c] = __fsub_rn(sp[c], pi[k][c]);
            const float d_sq = nb_collide::dot_rn<DIM>(d, d);
            const float r = __fadd_rn(ri[k], q.w);
            hit[k] |= d_sq <= __fmul_rn(r, r);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!hit[k]) continue;
        // The resolve path: the exact test and the pair math, in order.
        for (int b = 0; b < kBatch; ++b) {
          if (CHEB && cheb_dist<DIM>(ci[k], tile_c[buf][b0 + b]) > max_cheb)
            continue;
          const float4 p = tile_p[buf][b0 + b];
          const float4 v = tile_v[buf][b0 + b];
          const float sp[3] = {p.x, p.y, p.z};
          const float sv[3] = {v.x, v.y, v.z};
          collide_pair<DIM>(pi[k], vi[k], mi[k], ri[k], sp, sv, v.w, p.w,
                            impulse, acc_p[k], acc_v[k]);
        }
      }
    }
    if (more) {
      tile_p[buf ^ 1][threadIdx.x] = next.p;
      tile_v[buf ^ 1][threadIdx.x] = next.v;
      if (CHEB) tile_c[buf ^ 1][threadIdx.x] = next.c;
    }
    // One barrier a tile: buffer buf^1 was last read in pass t-1.
    __syncthreads();
  }

  if (slice > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        part[slice - 1][c][lane + kWarp * k] = acc_p[k][c];
        part[slice - 1][DIM + c][lane + kWarp * k] = acc_v[k][c];
      }
    }
  }
  __syncthreads();
  if (slice == 0) {
    float* dpos = out + static_cast<size_t>(blockIdx.y) * 2 * n * DIM;
    float* dvel = dpos + static_cast<size_t>(n) * DIM;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = first + kWarp * k;
#pragma unroll
      for (int sl = 0; sl < kSlices - 1; ++sl) {
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          acc_p[k][c] += part[sl][c][lane + kWarp * k];
          acc_v[k][c] += part[sl][DIM + c][lane + kWarp * k];
        }
      }
      if (i < n) {
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          dpos[i * DIM + c] = acc_p[k][c];
          dvel[i * DIM + c] = acc_v[k][c];
        }
      }
    }
  }
}

template <int DIM, bool RECT, bool CHEB>
void launch(const float* tpos, const float* tvel, const float* tmass,
            const float* trad, const int* tcell, const float* spos,
            const float* svel, const float* smass, const float* srad,
            const int* scell, float* out, int n, int s, int splits,
            int chunk, int max_cheb, float impulse, cudaStream_t stream) {
  const dim3 grid((n + kBlockTargets - 1) / kBlockTargets, splits);
  collide_kernel<DIM, RECT, CHEB><<<grid, kThreads, 0, stream>>>(
      tpos, tvel, tmass, trad, tcell, spos, svel, smass, srad, scell, out, n,
      s, chunk, max_cheb, impulse);
}

template <int DIM>
void launch_rect(const float* tpos, const float* tvel,
                 const float* tmass, const float* trad, const int* tcell,
                 const float* spos, const float* svel, const float* smass,
                 const float* srad, const int* scell, float* out, int n,
                 int s, int splits, int chunk, int max_cheb, float impulse,
                 cudaStream_t st) {
  if (max_cheb >= 0)
    launch<DIM, true, true>(tpos, tvel, tmass, trad, tcell, spos, svel,
                            smass, srad, scell, out, n, s, splits, chunk,
                            max_cheb, impulse, st);
  else
    launch<DIM, true, false>(tpos, tvel, tmass, trad, tcell, spos, svel,
                             smass, srad, scell, out, n, s, splits, chunk, 0,
                             impulse, st);
}

}  // namespace

// K2: out [2, n_rows, dim] = (dpos, dvel) of the targets [row0, row0 +
// n_rows) against all n particles; row0 = 0, n_rows = n is every particle
// (the row range is a rank's own rows of the multi-device step's gathered
// arrays). The targets are the same arrays from row0 on, so each target's
// sum runs over the sources in the same order either way.
extern "C" int nb_collision_deltas(
    const float* pos, const float* vel, const float* mass,
    const float* radius, float* out, int n, int row0, int n_rows, int dim,
    float impulse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_rows <= 0 || row0 < 0 || row0 > n - n_rows ||
      (dim != 2 && dim != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t t0 = static_cast<size_t>(row0);
  if (dim == 2)
    launch<2, false, false>(pos + t0 * 2, vel + t0 * 2, mass + t0,
                            radius + t0, nullptr, pos, vel, mass, radius,
                            nullptr, out, n_rows, n, 1, n, 0, impulse, st);
  else
    launch<3, false, false>(pos + t0 * 3, vel + t0 * 3, mass + t0,
                            radius + t0, nullptr, pos, vel, mass, radius,
                            nullptr, out, n_rows, n, 1, n, 0, impulse, st);
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
      (max_cheb >= 0 && (tcell == nullptr || scell == nullptr)) ||
      (dim != 2 && dim != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  // Chunks are whole tiles, so only the last one is ragged.
  const int per = (s + splits - 1) / splits;
  const int chunk = (per + kTile - 1) / kTile * kTile;
  float* dst = splits > 1 ? scratch : out;
  if (dim == 2)
    launch_rect<2>(tpos, tvel, tmass, trad, tcell, spos, svel, smass, srad,
                   scell, dst, n, s, splits, chunk, max_cheb, impulse, st);
  else
    launch_rect<3>(tpos, tvel, tmass, trad, tcell, spos, svel, smass, srad,
                   scell, dst, n, s, splits, chunk, max_cheb, impulse, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return nb_sum_splits(scratch, out, 2 * n * dim, splits, stream);
}
