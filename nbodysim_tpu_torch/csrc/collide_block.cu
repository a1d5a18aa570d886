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
//   |trailing key of j - trailing key of i| <= 1 (wrapping; the absolute
//     value of INT_MIN is INT_MIN, as in torch and XLA);
//   ok_i and ok_j (both in covered blocks and not extracted big bodies);
//   global row of j != global row of i;
//   then d^2 <= r^2 with m_j > 0, and the separating/approaching branch.
//
// Windows are summed in offset order, the rows of each in ascending order.
//
// What bounds it on the H100: reading the planes once (bytes); the pairs
// that pass the masks are ~2 a target on the galaxy merger, against the
// ~T rows of each window. Design: the rows that pass target i's key masks
// in window o are one contiguous run of the sorted rows, from
// (lead + offset, t - 1) to (lead + offset, t + 1). A CTA of 256 targets
// (one a thread) takes the windows one at a time:
//  A. It stages the window's keys in shared memory (2D as int2, 3D as
//     int4; read through L1 instead when they do not fit), the next
//     window's first rows already in registers, and each thread finds its
//     run: the first row by a branch-free binary search, the end by a
//     galloping search from there (a run is a few rows). The CTA's union of
//     runs is reduced with warp and shared-memory min/max, over the warps
//     whose longest run is longer than kDirect rows.
//  B1. A warp whose runs are all kDirect rows or shorter (the merger: a
//     few candidates a target, different from lane to lane) reads them
//     directly: each lane its own rows, the ok, self and overlap tests
//     first, the velocities only of the rows that overlap.
//  B2. The unions of all windows are streamed through shared memory in
//     tiles of 256 rows, packed on the way as float4 (x, y, z, m) and
//     (vx, vy, vz, r) by 4-byte cp.async copies, double-buffered so the
//     next tile (of this window or the next) is in flight while a thread
//     walks the part of its run that lies in the current one. A run longer
//     than a tile (a crowded cell) is walked tile after tile, so the rows
//     stay in ascending order and the sum is the one the masks give.
//     In 3D, a warp whose longest walk in a tile is kBatch rows or more
//     tests them kBatch at a time without branches (collide_pair's own
//     overlap test, bit for bit) and resolves only the hits, in row order,
//     as K2 does; other walks call collide_pair row by row.
// Only the ok test, the self-row test and collide_pair remain in the loop.
//
// int32 wrap: a window is walked by runs only when every ok target of the
// CTA and every ok row of the window has keys in [-2^30, 2^30). Then no
// key sum or difference can wrap, and the masks select exactly the run.
// Otherwise (cells near INT_MIN / INT_MAX) the CTA's threads walk that
// whole window with the exact wrapping key masks, as the plain version.
// A CTA whose targets are all uncovered (ok = 0) skips the work and writes
// zeros.
//
// The targets' global rows start at `row0` (a whole number of blocks), so a
// band of blocks, as the multi-GPU pass hands out, reuses the kernel.
//
// Measured on the N=1M galaxy merger (NVIDIA H100 80GB HBM3, 700 W;
// scripts/torch_kernel_ab.py): ~0.105 ms; the threads walk 1.49x the
// pairs the masks pass (their own row included), the lanes of a warp wait
// for its longest walk, and 45% of the pairs overlap and take the resolve
// path. Reading short runs directly (B1) took ~3% off streaming every run;
// a longer limit than kDirect = 8 rows (16, 32) was slower. Staging every
// union at once, a tile ring filled during the searches, and more CTAs an
// SM (fewer registers) were no faster.
//
// nb_block_collide_count launches the same kernel with counters (never on
// the simulation's path): rows walked by the threads (the lane-pairs
// issued), rows walked counting every lane of a warp to the warp's longest
// walk in each tile or run (the divergence), rows staged, pairs resolved,
// the SM cycles the CTAs spent finding their runs and walking them, and
// the rows that lanes read directly (B1).

#include <cuda_runtime.h>
#include <limits.h>

#include "collide_pair.cuh"

namespace {

using nb_collide::abs_wrap;
using nb_collide::collide_pair;
using nb_collide::sub_wrap;

constexpr int kThreads = 256;  // targets per CTA; T is a multiple of it
constexpr int kTile = 256;     // source rows per staged tile (one a thread)
constexpr int kBatch = 8;      // rows a branch-free overlap test takes
constexpr int kDirect = 8;     // a warp's longest run its lanes read directly
constexpr int kSafe = 1 << 30; // keys in [-kSafe, kSafe) cannot wrap
constexpr int kMaxSmem = 232448;  // a CTA's shared memory on the H100

// Staged source rows: two tiles of kTile.
struct Rows {
  float4 p[2 * kTile];  // x, y, z, m
  float4 v[2 * kTile];  // vx, vy, vz, r
  float ok[2 * kTile];
};

template <int DIM>
struct KeyRow;
template <>
struct KeyRow<2> {
  using T = int2;
};
template <>
struct KeyRow<3> {
  using T = int4;
};

__device__ __forceinline__ bool safe_key(int k) {
  return k >= -kSafe && k < kSafe;
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lex order of a row's keys (c0, c1[, c2]) against the query q, without
// branches; `upper` asks "row <= q" (the upper bound's test), else
// "row < q".
template <int DIM>
__device__ __forceinline__ bool row_before(const int* r, const int* q,
                                           bool upper) {
  const bool last = upper ? r[DIM - 1] <= q[DIM - 1] : r[DIM - 1] < q[DIM - 1];
  if constexpr (DIM == 2) return (r[0] < q[0]) | ((r[0] == q[0]) & last);
  return (r[0] < q[0]) |
         ((r[0] == q[0]) & ((r[1] < q[1]) | ((r[1] == q[1]) & last)));
}

// Row m's keys, from shared memory (`sk`, rows relative to `base`) or,
// with sk == nullptr, from the global key planes.
template <int DIM>
__device__ __forceinline__ void key_row(const typename KeyRow<DIM>::T* sk,
                                        int base, const int* __restrict__ keys,
                                        int n_tot, int m, int* r) {
  if (sk != nullptr) {
    const typename KeyRow<DIM>::T k = sk[m - base];
    r[0] = k.x;
    r[1] = k.y;
    if constexpr (DIM == 3) r[2] = k.z;
  } else {
#pragma unroll
    for (int c = 0; c < DIM; ++c)
      r[c] = keys[static_cast<size_t>(c) * n_tot + m];
  }
}

// First row in [lo, hi) that is not before q: a branch-free binary
// search (every lane of a warp takes the same number of steps).
template <int DIM>
__device__ __forceinline__ int lower_row(const typename KeyRow<DIM>::T* sk,
                                         int base,
                                         const int* __restrict__ keys,
                                         int n_tot, int lo, int hi,
                                         const int* q, bool upper) {
  int len = hi - lo;
  while (len > 0) {
    const int half = len >> 1;
    int r[DIM];
    key_row<DIM>(sk, base, keys, n_tot, lo + half, r);
    const bool before = row_before<DIM>(r, q, upper);
    lo = before ? lo + half + 1 : lo;
    len = before ? len - half - 1 : half;
  }
  return lo;
}

// The same from a row known not to be past the answer, galloping: runs
// are a few rows long, so this takes a few steps where a binary search
// over the window takes ~log2 of its length.
template <int DIM>
__device__ __forceinline__ int gallop_row(const typename KeyRow<DIM>::T* sk,
                                          int base,
                                          const int* __restrict__ keys,
                                          int n_tot, int lo, int hi,
                                          const int* q, bool upper) {
  int step = 1;
  while (lo < hi) {
    const int probe = min(lo + step, hi) - 1;
    int r[DIM];
    key_row<DIM>(sk, base, keys, n_tot, probe, r);
    if (!row_before<DIM>(r, q, upper))
      return lower_row<DIM>(sk, base, keys, n_tot, lo, probe, q, upper);
    lo = probe + 1;
    step <<= 1;
  }
  return lo;
}

// collide_pair's own first test, bit for bit: does the source overlap
// the target (d^2 <= (r_i + r_j)^2, explicitly rounded) with m_j > 0?
template <int DIM>
__device__ __forceinline__ bool overlaps(const float* pi, float ri,
                                         float4 p, float sr) {
  const float sp[3] = {p.x, p.y, p.z};
  float d[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) d[c] = __fsub_rn(sp[c], pi[c]);
  const float r = __fadd_rn(ri, sr);
  return nb_collide::dot_rn<DIM>(d, d) <= __fmul_rn(r, r) && p.w > 0.f;
}

// The exact wrapping key masks of row j against the target's keys tk.
template <int DIM>
__device__ __forceinline__ bool keys_match(const int* __restrict__ keys,
                                           int n_tot, int j, const int* tk,
                                           int off0, int off1) {
  if (keys[j] != static_cast<int>(static_cast<unsigned>(tk[0]) +
                                  static_cast<unsigned>(off0)))
    return false;
  if (DIM == 3 &&
      keys[static_cast<size_t>(n_tot) + j] !=
          static_cast<int>(static_cast<unsigned>(tk[1]) +
                           static_cast<unsigned>(off1)))
    return false;
  const int trail = keys[static_cast<size_t>(DIM - 1) * n_tot + j];
  return abs_wrap(sub_wrap(trail, tk[DIM - 1])) <= 1;
}

template <int DIM>
__host__ __device__ constexpr int n_off() {
  return DIM == 2 ? 3 : 9;
}

// Shared memory: the staged rows, the runs [n_off][kThreads] as int2, then
// the keys of one window (w_max rows) when they fit.
template <int DIM>
size_t smem_bytes(int w_max, bool keys_in_smem) {
  return sizeof(Rows) + sizeof(int2) * n_off<DIM>() * kThreads +
         (keys_in_smem ? sizeof(typename KeyRow<DIM>::T) * w_max : 0);
}

// Rows of a window whose keys a thread holds in registers for the next
// window (the rest are read when the window is staged).
constexpr int kPre = 4;

template <int DIM, bool COUNT>
__global__ void __launch_bounds__(kThreads, 4)
block_collide_kernel(const float* __restrict__ planes,
                     const int* __restrict__ keys,
                     const int* __restrict__ w_lo,
                     const int* __restrict__ w_hi, float* __restrict__ dpos,
                     float* __restrict__ dvel, int n_tot, int t_blk,
                     int row0, float impulse, int w_max, bool keys_in_smem,
                     unsigned long long* __restrict__ counts) {
  constexpr int kOff = n_off<DIM>();
  using KRow = typename KeyRow<DIM>::T;
  // planes: [2 DIM + 3][n_tot] = pos DIM, vel DIM, mass, radius, ok.
  const float* mass = planes + static_cast<size_t>(2 * DIM) * n_tot;
  const float* rad = mass + n_tot;
  const float* okp = rad + n_tot;
  extern __shared__ __align__(16) unsigned char smem[];
  Rows& rows = *reinterpret_cast<Rows*>(smem);
  int2* runs = reinterpret_cast<int2*>(&rows + 1);  // [kOff][kThreads]
  KRow* skeys = reinterpret_cast<KRow*>(runs + kOff * kThreads);
  __shared__ int u_lo[kOff], u_hi[kOff];  // each window's union of runs
  __shared__ int2 wb[kOff];               // the block's windows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int local = blockIdx.x * kThreads + tid;
  const int row = row0 + local;
  const int blk = (row0 + blockIdx.x * kThreads) / t_blk;
  const long long t0 = COUNT ? clock64() : 0;
  long long t1 = t0;

  // Every load that needs nothing else is issued before the first barrier:
  // the target, the windows and the first window's keys.
  const bool oki = okp[row] > 0.f;
  if (tid < kOff) {
    wb[tid] = make_int2(w_lo[blk * kOff + tid], w_hi[blk * kOff + tid]);
    // Empty: (INT_MAX, 0), so that u_hi - u_lo cannot overflow.
    u_lo[tid] = INT_MAX;
    u_hi[tid] = 0;
  }
  // The first kPre rows a thread stages of each window, loaded one window
  // ahead.
  int pre[kPre][DIM];
  auto prefetch = [&](int lo, int hi) {
#pragma unroll
    for (int p = 0; p < kPre; ++p) {
      const int j = lo + tid + p * kThreads;
#pragma unroll
      for (int c = 0; c < DIM; ++c)
        pre[p][c] = j < hi ? keys[static_cast<size_t>(c) * n_tot + j] : 0;
    }
  };
  prefetch(w_lo[blk * kOff], w_hi[blk * kOff]);
  float pi[DIM], vi[DIM];
  int tk[DIM];
  bool safe = true;
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    pi[c] = planes[static_cast<size_t>(c) * n_tot + row];
    vi[c] = planes[static_cast<size_t>(DIM + c) * n_tot + row];
    tk[c] = keys[static_cast<size_t>(c) * n_tot + row];
    safe = safe && safe_key(tk[c]);
  }
  const float mi = mass[row];
  const float ri = rad[row];
  float acc_p[DIM], acc_v[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) acc_p[c] = acc_v[c] = 0.f;
  unsigned issued = 0, slots = 0, staged = 0, overlapping = 0, direct = 0;

  if (__syncthreads_or(oki)) {
    // Every ok target's keys are safe.
    const bool targets_safe = __syncthreads_and(!oki || safe);
    unsigned wide = 0;  // bit o: window o takes the exact masks
    int longest_run = 0;

    // A. Each thread's run in each window, and the CTA's union.
    for (int o = 0; o < kOff; ++o) {
      // lead_offs order: dx outer, dy inner, each in (-1, 0, 1).
      const int off0 = DIM == 2 ? o - 1 : o / 3 - 1;
      const int off1 = o % 3 - 1;
      const int lo = wb[o].x;
      const int hi = wb[o].y;
      const bool in_smem = keys_in_smem && hi - lo <= w_max;
      // Stage the window's keys (the prefetched rows, then any beyond
      // them) and look for ok rows whose keys leave the safe range.
      bool unsafe_row = false;
      auto take = [&](int j, const int* r) {
        if (in_smem) {
          KRow k;
          k.x = r[0];
          k.y = r[1];
          if constexpr (DIM == 3) {
            k.z = r[2];
            k.w = 0;
          }
          skeys[j - lo] = k;
        }
        bool s = true;
#pragma unroll
        for (int c = 0; c < DIM; ++c) s = s && safe_key(r[c]);
        unsafe_row = unsafe_row || (!s && okp[j] > 0.f);
      };
#pragma unroll
      for (int p = 0; p < kPre; ++p) {
        const int j = lo + tid + p * kThreads;
        if (j < hi) take(j, pre[p]);
      }
      for (int j = lo + tid + kPre * kThreads; j < hi; j += kThreads) {
        int r[DIM];
#pragma unroll
        for (int c = 0; c < DIM; ++c)
          r[c] = keys[static_cast<size_t>(c) * n_tot + j];
        take(j, r);
      }
      if (o + 1 < kOff) prefetch(wb[o + 1].x, wb[o + 1].y);
      const bool exact = __syncthreads_or(unsafe_row) || !targets_safe;
      if (exact) wide |= 1u << o;
      int rlo = lo, rhi = lo;
      if (oki) {
        if (exact) {
          rhi = hi;
        } else {
          int q[DIM];
          q[0] = tk[0] + off0;
          if (DIM == 3) q[1] = tk[1] + off1;
          q[DIM - 1] = tk[DIM - 1] - 1;
          const KRow* sk = in_smem ? skeys : nullptr;
          rlo = lower_row<DIM>(sk, lo, keys, n_tot, lo, hi, q, false);
          q[DIM - 1] = tk[DIM - 1] + 1;
          rhi = gallop_row<DIM>(sk, lo, keys, n_tot, rlo, hi, q, true);
        }
      }
      runs[o * kThreads + tid] = make_int2(rlo, rhi);
      longest_run = max(longest_run, rhi - rlo);
      __syncthreads();  // the keys buffer is reused by the next window
    }
    // A warp whose runs are all short reads its rows directly; the others
    // put their runs into the unions that phase B streams.
    const bool lanes_direct =
        __reduce_max_sync(0xffffffffu, longest_run) <= kDirect;
    if (!lanes_direct) {
      for (int o = 0; o < kOff; ++o) {
        const int2 r = runs[o * kThreads + tid];
        const bool any = r.x < r.y;
        const int wlo = __reduce_min_sync(0xffffffffu, any ? r.x : INT_MAX);
        const int whi = __reduce_max_sync(0xffffffffu, any ? r.y : 0);
        if (lane == 0 && wlo < whi) {
          atomicMin(&u_lo[o], wlo);
          atomicMax(&u_hi[o], whi);
        }
      }
    }
    __syncthreads();
    if (COUNT) t1 = clock64();

    // B1. Short runs: each lane reads its own rows from the planes, in
    // window and row order, and the rest only of the rows that pass the ok
    // and self tests and overlap. Warps take this path or phase B2 as a
    // whole; a CTA whose warps all take it stages nothing.
    if (lanes_direct) {
      for (int o = 0; o < kOff; ++o) {
        const int2 r = runs[o * kThreads + tid];
        const bool exact = (wide >> o) & 1u;
        const int off0 = DIM == 2 ? o - 1 : o / 3 - 1;
        const int off1 = o % 3 - 1;
        for (int j = r.x; j < r.y; ++j) {
          if (exact && !keys_match<DIM>(keys, n_tot, j, tk, off0, off1))
            continue;
          if (!(okp[j] > 0.f) || j == row) continue;
          float sp[3] = {0.f, 0.f, 0.f}, sv[3] = {0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < DIM; ++c)
            sp[c] = planes[static_cast<size_t>(c) * n_tot + j];
          const float sm = mass[j];
          const float sr = rad[j];
          if (!overlaps<DIM>(pi, ri, make_float4(sp[0], sp[1], sp[2], sm),
                             sr))
            continue;
#pragma unroll
          for (int c = 0; c < DIM; ++c)
            sv[c] = planes[static_cast<size_t>(DIM + c) * n_tot + j];
          collide_pair<DIM>(pi, vi, mi, ri, sp, sv, sm, sr, impulse, acc_p,
                            acc_v);
          if (COUNT) ++overlapping;
        }
        if (COUNT) {
          const unsigned walked = static_cast<unsigned>(max(r.y - r.x, 0));
          const unsigned longest = __reduce_max_sync(0xffffffffu, walked);
          issued += walked;
          direct += walked;
          if (lane == 0) slots += 32u * longest;
        }
      }
    }

    // B2. Stream the unions through two tiles, window after window, and
    // walk the part of each run that is staged (every warp stages; the
    // direct ones walk nothing).
    auto next = [&](int& o, int& base) {
      while (o < kOff && base >= u_hi[o])
        if (++o < kOff) base = u_lo[o];
    };
    auto stage = [&](int buf, int o, int base) {
      const int j = base + tid;
      const int k = buf * kTile + tid;
      if (j < u_hi[o]) {
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          cp_async4(reinterpret_cast<float*>(&rows.p[k]) + c,
                    planes + static_cast<size_t>(c) * n_tot + j);
          cp_async4(reinterpret_cast<float*>(&rows.v[k]) + c,
                    planes + static_cast<size_t>(DIM + c) * n_tot + j);
        }
        cp_async4(&rows.p[k].w, mass + j);
        cp_async4(&rows.v[k].w, rad + j);
        cp_async4(&rows.ok[k], okp + j);
        if (COUNT) ++staged;
      }
      cp_async_commit();
    };
    int co = 0, cb = u_lo[0];
    next(co, cb);
    int buf = 0;
    if (co < kOff) stage(0, co, cb);
    while (co < kOff) {
      int no = co, nbase = cb + kTile;
      next(no, nbase);
      if (no < kOff) {
        stage(buf ^ 1, no, nbase);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int2 r = runs[co * kThreads + tid];
      const int a = max(r.x, cb);
      const int e = lanes_direct ? a : min(r.y, cb + kTile);
      const int kofs = buf * kTile - cb;  // row j is staged at j + kofs
      const bool exact = (wide >> co) & 1u;
      const int off0 = DIM == 2 ? co - 1 : co / 3 - 1;
      const int off1 = co % 3 - 1;
      // Row j passes the masks and overlaps the target.
      auto hit = [&](int j) {
        const int k = j + kofs;
        return rows.ok[k] > 0.f && j != row &&
               overlaps<DIM>(pi, ri, rows.p[k], rows.v[k].w) &&
               (!exact || keys_match<DIM>(keys, n_tot, j, tk, off0, off1));
      };
      auto resolve = [&](int j) {
        const float4 p = rows.p[j + kofs];
        const float4 v = rows.v[j + kofs];
        const float sp[3] = {p.x, p.y, p.z};
        const float sv[3] = {v.x, v.y, v.z};
        collide_pair<DIM>(pi, vi, mi, ri, sp, sv, p.w, v.w, impulse, acc_p,
                          acc_v);
        if (COUNT) ++overlapping;
      };
      const unsigned walked = static_cast<unsigned>(max(e - a, 0));
      const unsigned longest = __reduce_max_sync(0xffffffffu, walked);
      // 3D only: in 2D the batch's registers slowed the short walks more
      // than it saved on the long ones.
      if (DIM == 3 && longest >= kBatch) {
        // Long walks (crowded cells): a branch-free test of kBatch rows,
        // then the resolve path for the hits, in row order.
        for (int j0 = a; j0 < e; j0 += kBatch) {
          unsigned hits = 0;
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            hits |= static_cast<unsigned>(j0 + u < e && hit(j0 + u)) << u;
          while (hits) {
            resolve(j0 + __ffs(hits) - 1);
            hits &= hits - 1;
          }
        }
      } else {
        // Short walks: collide_pair makes the overlap test itself.
        for (int j = a; j < e; ++j) {
          if (exact && !keys_match<DIM>(keys, n_tot, j, tk, off0, off1))
            continue;
          const int k = j + kofs;
          if (!(rows.ok[k] > 0.f) || j == row) continue;
          if (COUNT && !overlaps<DIM>(pi, ri, rows.p[k], rows.v[k].w))
            continue;
          resolve(j);
        }
      }
      if (COUNT) {
        issued += walked;
        if (lane == 0) slots += 32u * longest;
      }
      __syncthreads();  // the buffer is restaged two steps on
      co = no;
      cb = nbase;
      buf ^= 1;
    }
  }
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    dpos[static_cast<size_t>(local) * DIM + c] = acc_p[c];
    dvel[static_cast<size_t>(local) * DIM + c] = acc_v[c];
  }
  if (COUNT) {
    if (tid == 0) {
      const long long t2 = clock64();
      atomicAdd(counts + 4, static_cast<unsigned long long>(t1 - t0));
      atomicAdd(counts + 5, static_cast<unsigned long long>(t2 - t1));
    }
    const unsigned vals[5] = {issued, slots, staged, overlapping, direct};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const unsigned w = __reduce_add_sync(0xffffffffu, vals[i]);
      if (lane == 0)
        atomicAdd(counts + (i < 4 ? i : 6),
                  static_cast<unsigned long long>(w));
    }
  }
}

template <int DIM, bool COUNT>
int launch(const float* planes, const int* keys, const int* w_lo,
           const int* w_hi, float* dpos, float* dvel, int n_tot, int t_blk,
           int row0, int n_loc, float impulse, unsigned long long* counts,
           cudaStream_t st) {
  const int w_max = 2 * t_blk + 512;  // kernels/collide_block.window_length
  // The window's keys in shared memory where they fit (2D up to T =
  // 12,544, 3D up to T = 5,632), else read through L1.
  const bool keys_in_smem = smem_bytes<DIM>(w_max, true) <= kMaxSmem;
  const size_t bytes = smem_bytes<DIM>(w_max, keys_in_smem);
  auto kernel = block_collide_kernel<DIM, COUNT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_loc / kThreads, kThreads, bytes, st>>>(
      planes, keys, w_lo, w_hi, dpos, dvel, n_tot, t_blk, row0, impulse,
      w_max, keys_in_smem, counts);
  return static_cast<int>(cudaGetLastError());
}

template <bool COUNT>
int dispatch(const float* planes, const int* keys, const int* w_lo,
             const int* w_hi, float* dpos, float* dvel, int n_tot, int dim,
             int t_blk, int row0, int n_loc, float impulse,
             unsigned long long* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_loc <= 0 || t_blk <= 0 || t_blk % kThreads || row0 % t_blk ||
      n_loc % t_blk || row0 + n_loc > n_tot)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dim == 2)
    return launch<2, COUNT>(planes, keys, w_lo, w_hi, dpos, dvel, n_tot,
                            t_blk, row0, n_loc, impulse, counts, st);
  if (dim == 3)
    return launch<3, COUNT>(planes, keys, w_lo, w_hi, dpos, dvel, n_tot,
                            t_blk, row0, n_loc, impulse, counts, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
  return dispatch<false>(planes, keys, w_lo, w_hi, dpos, dvel, n_tot, dim,
                         t_blk, row0, n_loc, impulse, nullptr, stream);
}

// The same, counting into counts[7] (uint64, zeroed by the caller): rows
// walked by the threads, rows walked with every lane of a warp counted to
// the warp's longest walk in each tile (or run, on the direct path), rows
// staged into tiles, pairs that reached the resolve path (they pass the
// masks and overlap), the SM cycles of the CTAs in phase A and in phase B
// (summed over the CTAs), and the rows of the walked ones that lanes read
// directly.
extern "C" int nb_block_collide_count(const float* planes, const int* keys,
                                      const int* w_lo, const int* w_hi,
                                      float* dpos, float* dvel, int n_tot,
                                      int dim, int t_blk, int row0,
                                      int n_loc, float impulse,
                                      unsigned long long* counts,
                                      void* stream) {
  return dispatch<true>(planes, keys, w_lo, w_hi, dpos, dvel, n_tot, dim,
                        t_blk, row0, n_loc, impulse, counts, stream);
}
