// K6: dense stage of the lex-sorted block collision pass, f32.
//
// Replaces the TPU kernel
// nbodysim_tpu/kernels/collide_block.py:_block_collide_kernel (wrapper
// block_collision_deltas). The particles arrive sorted lexicographically by
// their integer cell coordinates and padded to whole blocks of T targets.
// For every block, the caller found by binary search n_off (3 in 2D, 9 in
// 3D) contiguous windows [w_lo, w_hi) of sorted rows: those whose lead-axis
// cell keys equal the block's keys plus one neighbour offset, with the
// trailing key within +-1. Each target i of the block sums, over the
// sources j of each window, the pair corrections of collide_pair.cuh, for
// the pairs that pass the block pass's masks in this order:
//
//   lead keys of j == lead keys of i + the window's offset (int32, wrapping);
//   |trailing key of j - trailing key of i| <= 1;
//   ok_i and ok_j (both in covered blocks and not extracted big bodies);
//   global row of j != global row of i;
//   then d^2 <= r^2 with m_j > 0, and the separating/approaching branch.
//
// Padding rows have mass 0 and ok 0; their radius fill (-1e9) squares to a
// huge r^2, so they are excluded by those masks, never by the overlap test.
//
// What bounds it on the H100: the key tests of the pairs in the windows'
// true spans (sum over covered blocks of T * (w_hi - w_lo)), a few integer
// ops per pair; few of them reach the overlap test. Design: the TPU kernel
// received [nb, n_off, W] window gathers (a TPU layout that would copy every
// plane three or nine times); here a CTA of 256 threads, one per target,
// reads its block's window bounds and stages each window's rows straight
// from the sorted planes through shared memory, 256 rows at a time. The
// windows' true spans hold every source the key masks accept, so this is
// the same set of pairs. A CTA whose targets are all uncovered (ok = 0)
// skips the work outright and writes zeros.
//
// The targets' global rows start at `row0` (a whole number of blocks), so a
// band of blocks, as the multi-GPU pass hands out, reuses the kernel.

#include <cuda_runtime.h>

#include "collide_pair.cuh"

namespace {

using nb_collide::abs_wrap;
using nb_collide::collide_pair;
using nb_collide::sub_wrap;

constexpr int kThreads = 256;  // targets per CTA; T is a multiple of it

template <int DIM>
__global__ void __launch_bounds__(kThreads)
block_collide_kernel(const float* __restrict__ planes,
                     const int* __restrict__ keys,
                     const int* __restrict__ w_lo,
                     const int* __restrict__ w_hi, float* __restrict__ dpos,
                     float* __restrict__ dvel, int n_tot, int t_blk,
                     int row0, float impulse) {
  constexpr int kOff = DIM == 2 ? 3 : 9;
  // planes: [2 DIM + 3][n_tot] = pos DIM, vel DIM, mass, radius, ok.
  const float* mass = planes + static_cast<size_t>(2 * DIM) * n_tot;
  const float* rad = mass + n_tot;
  const float* okp = rad + n_tot;
  __shared__ float4 tile_p[kThreads];  // x, y, z, m
  __shared__ float4 tile_v[kThreads];  // vx, vy, vz, r
  __shared__ int4 tile_k[kThreads];    // keys, ok

  const int local = blockIdx.x * kThreads + threadIdx.x;
  const int row = row0 + local;
  const int blk = (row0 + blockIdx.x * kThreads) / t_blk;

  float pi[DIM], vi[DIM];
  int tk[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    pi[c] = planes[static_cast<size_t>(c) * n_tot + row];
    vi[c] = planes[static_cast<size_t>(DIM + c) * n_tot + row];
    tk[c] = keys[static_cast<size_t>(c) * n_tot + row];
  }
  const float mi = mass[row];
  const float ri = rad[row];
  const bool oki = okp[row] > 0.f;
  float acc_p[DIM], acc_v[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) acc_p[c] = acc_v[c] = 0.f;

  if (__syncthreads_or(oki)) {
    for (int o = 0; o < kOff; ++o) {
      // lead_offs order: dx outer, dy inner, each in (-1, 0, 1).
      const int off0 = DIM == 2 ? o - 1 : o / 3 - 1;
      const int off1 = o % 3 - 1;
      const int lo = w_lo[blk * kOff + o];
      const int hi = w_hi[blk * kOff + o];
      for (int base = lo; base < hi; base += kThreads) {
        const int j = base + threadIdx.x;
        if (j < hi) {
          float4 p, v;
          p.x = planes[j];
          p.y = planes[static_cast<size_t>(n_tot) + j];
          p.z = DIM == 3 ? planes[static_cast<size_t>(2) * n_tot + j] : 0.f;
          p.w = mass[j];
          v.x = planes[static_cast<size_t>(DIM) * n_tot + j];
          v.y = planes[static_cast<size_t>(DIM + 1) * n_tot + j];
          v.z = DIM == 3 ? planes[static_cast<size_t>(DIM + 2) * n_tot + j]
                         : 0.f;
          v.w = rad[j];
          tile_p[threadIdx.x] = p;
          tile_v[threadIdx.x] = v;
          tile_k[threadIdx.x] = make_int4(
              keys[j], keys[static_cast<size_t>(n_tot) + j],
              DIM == 3 ? keys[static_cast<size_t>(2) * n_tot + j] : 0,
              okp[j] > 0.f);
        }
        __syncthreads();
        const int count = min(kThreads, hi - base);
        if (oki) {
          for (int k = 0; k < count; ++k) {
            const int4 q = tile_k[k];
            if (q.x != static_cast<int>(static_cast<unsigned>(tk[0]) +
                                        static_cast<unsigned>(off0)))
              continue;
            if (DIM == 3 &&
                q.y != static_cast<int>(static_cast<unsigned>(tk[1]) +
                                        static_cast<unsigned>(off1)))
              continue;
            const int trail = DIM == 2 ? q.y : q.z;
            if (abs_wrap(sub_wrap(trail, tk[DIM - 1])) > 1) continue;
            if (!q.w || base + k == row) continue;
            const float4 p = tile_p[k];
            const float4 v = tile_v[k];
            const float sp[3] = {p.x, p.y, p.z};
            const float sv[3] = {v.x, v.y, v.z};
            collide_pair<DIM>(pi, vi, mi, ri, sp, sv, p.w, v.w, impulse,
                              acc_p, acc_v);
          }
        }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    dpos[static_cast<size_t>(local) * DIM + c] = acc_p[c];
    dvel[static_cast<size_t>(local) * DIM + c] = acc_v[c];
  }
}

}  // namespace

// planes [2 dim + 3, n_tot] f32, keys [dim, n_tot] int32, w_lo / w_hi
// [n_tot / t_blk, n_off] int32 (all blocks). Targets: the n_loc rows from
// row0 (both multiples of t_blk, t_blk a multiple of 256); dpos / dvel
// [n_loc, dim].
extern "C" int nb_block_collide(const float* planes, const int* keys,
                                const int* w_lo, const int* w_hi,
                                float* dpos, float* dvel, int n_tot, int dim,
                                int t_blk, int row0, int n_loc, float impulse,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_loc <= 0 || t_blk <= 0 || t_blk % kThreads || row0 % t_blk ||
      n_loc % t_blk || row0 + n_loc > n_tot)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n_loc / kThreads;
  if (dim == 2) {
    block_collide_kernel<2><<<grid, kThreads, 0, st>>>(
        planes, keys, w_lo, w_hi, dpos, dvel, n_tot, t_blk, row0, impulse);
  } else if (dim == 3) {
    block_collide_kernel<3><<<grid, kThreads, 0, st>>>(
        planes, keys, w_lo, w_hi, dpos, dvel, n_tot, t_blk, row0, impulse);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
