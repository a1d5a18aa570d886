// The near-field kernel of the tree codes, shared by K3 (2D, nearfield.cu)
// and K7 (3D, nearfield3.cu): one template over the grid's dimension. The
// .cu files say what each replaces and what bounds it; this header holds the
// design they share.
//
// Input: the bucket grid b* [rows + 2rr, res(, res), K] (K slots per finest
// cell, rr halo rows / x-slabs before and after the `rows` target ones) and
// counts [rows + 2rr, res(, res)] int32, the occupied slots of each cell:
// slots 0 .. count-1 hold the cell's particles, the slots above are empty
// (mass 0). Output a* [rows, res(, res), K]: for every target slot below its
// cell's count, the sum over the occupied slots of the (2rr+1)^D cells
// around it of
//
//   m_s (x_s - x_t) (|x_s - x_t|^2 + eps^2)^(-3/2),
//
// and exactly 0 at every slot at or above the count. A massless target below
// the count (a heavy body the tree zeroed) is computed like any other.
//
// Design. A block of 256 threads covers a tile of 128 target cells (2D:
// 8 rows x 16 columns; 3D: 4 x 4 x 8 along x, y, z) and its rr-cell halo,
// cut into lines along the grid's innermost axis (2D: rows; 3D: the (x, y)
// lines along z), 2rr + 16 or 2rr + 8 cells long.
//  1. The counts of every staged cell are loaded at once; one warp a line
//     prefix-sums them with shuffles (each cell's offset inside its line), a
//     second scan gives each line's start, a third the compacted list of the
//     tile's occupied target slots, (cell, slot) in cell order.
//  2. The occupied slots of the lines are staged in shared memory as float4
//     (2D: x, y, m, -; 3D: x, y, z, m), line after line, compacted: the
//     2rr + 1 cells around a target along a line are one contiguous run, so a
//     target reads (2rr+1)^(D-1) runs of ~(2rr+1) x occupancy sources, not
//     (2rr+1)^D runs of ~occupancy. Four lanes a cell issue cp.async copies
//     (no register round trip, all in flight at once) while the target list
//     is built and the zeros written.
//  3. The slots at or above each target cell's count are written 0, as
//     float4 where a quarter of a 16-slot cell is empty.
//  4. Each thread takes one target of the compacted list (the block walks
//     the list in passes of 256) and sums its runs. Consecutive lanes are
//     consecutive slots of one cell, or neighbouring cells of one line, so
//     they read the same or nearby staged sources.
// Lines are staged in chunks of at most kStage sources (32 KB); a tile
// that does not fit (cells filled to K, the clustered case) is staged chunk
// by chunk inside step 4, once for every pass of targets. A line of full
// cells always fits. A target adds its runs in line order whatever the
// chunking, and each run's sum is added to its total as one term: a fixed
// order with no atomics, so the result is deterministic. The reciprocal
// square root is MUFU.RSQ with denormal inputs flushed (rsqrt.approx.ftz),
// as in K1: for d^2 < 1.2e-38 the weight overflows to inf either way.
//
// Measured at N = 1M (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// scripts/torch_kernel_ab.py): K3 0.119-0.123 ms and K7 0.180-0.182 ms.
// What keeps the pair loop from K1's rate: a warp runs each run to its
// longest lane, and a tile's ~512 targets take 2 or 3 passes of 256.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCap = 16;    // slots per cell (a slot id takes 4 bits)
constexpr int kMaxRR = 4;      // halo cells (acceptance radius <= 5)
constexpr int kStage = 2048;   // staged sources a chunk: 32 KB of float4

template <int DIM>
struct Tile;
template <>
struct Tile<2> {  // rows x columns
  static constexpr int A = 8, B = 1, C = 16;
};
template <>
struct Tile<3> {  // x x y x z
  static constexpr int A = 4, B = 4, C = 8;
};
constexpr int kTileCells = 128;
static_assert(Tile<2>::A * Tile<2>::B * Tile<2>::C == kTileCells, "tile");
static_assert(Tile<3>::A * Tile<3>::B * Tile<3>::C == kTileCells, "tile");
static_assert(kTileCells * kMaxCap <= 65536, "target codes are 16 bits");
static_assert((Tile<2>::C + 2 * kMaxRR) * kMaxCap <= kStage &&
              (Tile<3>::C + 2 * kMaxRR) * kMaxCap <= kStage,
              "a line of full cells must fit one chunk");
static_assert(Tile<2>::C + 2 * kMaxRR <= 32 && Tile<3>::C + 2 * kMaxRR <= 32,
              "a line is scanned by one warp");

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One f32 from device memory to shared memory, asynchronously (sm_80+);
// completed by cp.async.wait_all.
__device__ __forceinline__ void copy_async(float* smem_dst,
                                           const float* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// out[i] = in[0] + ... + in[i-1] for i <= n, by one whole warp.
__device__ void warp_exclusive_scan(const int* in, int* out, int n,
                                    int lane) {
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const int v = i < n ? in[i] : 0;
    const int inc = warp_inclusive_scan(v, lane);
    if (i < n) out[i] = carry + inc - v;
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lane == 0) out[n] = carry;
}

// Shared memory beyond the staged sources, in ints: per line its S + 1
// offsets, total, base and chunk entry (+2 for base[L], chunk[L]); per
// target cell its count and start (+1); the 16-bit target list.
template <int DIM>
__host__ __device__ constexpr int index_ints(int rr, int cap) {
  return ((Tile<DIM>::A + 2 * rr) * (DIM == 3 ? Tile<DIM>::B + 2 * rr : 1)) *
             (Tile<DIM>::C + 2 * rr + 4) + 2 +
         2 * kTileCells + 1 + (kTileCells * cap + 1) / 2;
}

template <int DIM>
__host__ __device__ constexpr int smem_bytes(int rr, int cap) {
  return kStage * static_cast<int>(sizeof(float4)) +
         4 * index_ints<DIM>(rr, cap);
}

template <int DIM>
__device__ __forceinline__ size_t cell_index(int xw, int y, int z, int res) {
  return DIM == 3 ? (static_cast<size_t>(xw) * res + y) * res + z
                  : static_cast<size_t>(xw) * res + z;
}

// Issue the copies of the occupied slots of lines lo .. hi-1 into the
// stage, compacted (completed by cp.async.wait_all): four lanes a cell, a
// lane every fourth slot, so a warp reads eight neighbouring cells' slots,
// contiguous in the grid, per array; cp.async copies each value to its
// place in shared memory with no register round trip, so every load of the
// chunk is in flight at once.
template <int DIM>
__device__ __forceinline__ void stage_lines(
    float4* stage, const int* off, const int* base, int lo, int hi, int S,
    int LB, int a0, int b0, int c0, int rr, int res, int cap,
    const float* __restrict__ bx, const float* __restrict__ by,
    const float* __restrict__ bz, const float* __restrict__ bm) {
  constexpr int kLanes = 4;
  const int S1 = S + 1;
  const int q = threadIdx.x % kLanes;
  for (int lc = threadIdx.x / kLanes; lc < (hi - lo) * S;
       lc += kThreads / kLanes) {
    const int l = lo + lc / S;
    const int c = lc - (l - lo) * S;
    const int o0 = off[l * S1 + c];
    const int n = off[l * S1 + c + 1] - o0;
    if (q >= n) continue;
    const int a = l / LB;
    const size_t src =
        cell_index<DIM>(a0 + a, b0 - rr + (l - a * LB), c0 - rr + c, res) *
        cap;
    float* dst = reinterpret_cast<float*>(stage + (base[l] - base[lo] + o0));
    for (int s = q; s < n; s += kLanes) {
      copy_async(dst + 4 * s, bx + src + s);
      copy_async(dst + 4 * s + 1, by + src + s);
      if (DIM == 3) {
        copy_async(dst + 4 * s + 2, bz + src + s);
        copy_async(dst + 4 * s + 3, bm + src + s);
      } else {
        copy_async(dst + 4 * s + 2, bm + src + s);  // .w is never read in 2D
      }
    }
  }
}

template <int DIM, bool MASK>
__global__ void __launch_bounds__(kThreads)
nearfield_kernel(const float* __restrict__ bx, const float* __restrict__ by,
                 const float* __restrict__ bz, const float* __restrict__ bm,
                 const int* __restrict__ counts, float* __restrict__ ax,
                 float* __restrict__ ay, float* __restrict__ az, int rows,
                 int res, int cap, int rr, float eps_sq) {
  using T = Tile<DIM>;
  const int width = 2 * rr + 1;
  const int LB = DIM == 3 ? T::B + 2 * rr : 1;  // lines along y (3D)
  const int L = (T::A + 2 * rr) * LB;            // lines of the tile
  const int S = T::C + 2 * rr;                   // cells a line
  const int S1 = S + 1;
  const int rows_w = rows + 2 * rr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Tile origin in target coordinates; the staged line l = a LB + b covers
  // window row / slab a0 + a and y = b0 - rr + b, its cell c sits at
  // c0 - rr + c.
  const int c0 = blockIdx.x * T::C;
  const int b0 = DIM == 3 ? blockIdx.y * T::B : 0;
  const int a0 = (DIM == 3 ? blockIdx.z : blockIdx.y) * T::A;

  extern __shared__ float4 stage[];                 // [kStage]
  int* off = reinterpret_cast<int*>(stage + kStage);  // [L][S1]
  int* total = off + L * S1;                        // [L]
  int* base = total + L;                            // [L + 1]
  int* chunk = base + L + 1;                        // [L + 1]
  int* tcount = chunk + L + 1;                      // [kTileCells]
  int* tstart = tcount + kTileCells;                // [kTileCells + 1]
  uint16_t* tgt = reinterpret_cast<uint16_t*>(tstart + kTileCells + 1);
  __shared__ int n_chunks;

  // 1. Every staged cell's count (0 past the grid), all loads in flight at
  //    once, into its line's offset row; the tile's target counts (0 for
  //    cells outside the target rows, whose halo cells are sources only).
  for (int e = threadIdx.x; e < L * S; e += kThreads) {
    const int l = e / S;
    const int c = e - l * S;
    const int a = l / LB;
    const int b = l - a * LB;
    const int y = b0 - rr + b;
    const int z = c0 - rr + c;
    int cnt = 0;
    if (a0 + a < rows_w && z >= 0 && z < res &&
        (DIM == 2 || (y >= 0 && y < res)))
      cnt = min(max(__ldg(counts + cell_index<DIM>(a0 + a, y, z, res)), 0),
                cap);
    off[l * S1 + c + 1] = cnt;
    const int ta = a - rr, tb = DIM == 3 ? b - rr : 0, tc = c - rr;
    if (ta >= 0 && ta < T::A && tb >= 0 && tb < T::B && tc >= 0 &&
        tc < T::C)
      tcount[(ta * T::B + tb) * T::C + tc] =
          a0 + ta < rows && z < res && (DIM == 2 || y < res) ? cnt : 0;
  }
  __syncthreads();
  // 2. Offsets of the cells inside each line (a warp a line).
  for (int l = warp; l < L; l += kWarps) {
    const int cnt = lane < S ? off[l * S1 + lane + 1] : 0;
    const int inc = warp_inclusive_scan(cnt, lane);
    if (lane < S) off[l * S1 + lane + 1] = inc;
    if (lane == 0) off[l * S1] = 0;
    if (lane == 31) total[l] = inc;
  }
  __syncthreads();
  if (warp == 0) warp_exclusive_scan(total, base, L, lane);
  if (warp == 1) warp_exclusive_scan(tcount, tstart, kTileCells, lane);
  __syncthreads();

  // 3. When every line fits one chunk (the usual case), stage them now and
  //    let the copies land while the rest of this phase runs. Otherwise
  //    chunks of whole lines of at most kStage sources, staged in step 4.
  //    Then the compacted target list, and zeros at the empty target slots.
  const bool one_chunk = base[L] <= kStage;
  if (one_chunk) {
    stage_lines<DIM>(stage, off, base, 0, L, S, LB, a0, b0, c0, rr, res, cap,
                     bx, by, bz, bm);
  } else if (threadIdx.x == 0) {
    int n = 0;
    chunk[0] = 0;
    for (int first = 0; first < L;) {
      int last = first + 1;
      while (last < L && base[last + 1] - base[first] <= kStage) ++last;
      chunk[++n] = last;
      first = last;
    }
    n_chunks = n;
  }
  for (int t = threadIdx.x; t < kTileCells; t += kThreads) {
    const int start = tstart[t];
    for (int s = 0; s < tcount[t]; ++s)
      tgt[start + s] = static_cast<uint16_t>(t * kMaxCap + s);
  }
  // A lane a quarter of a cell's slots; float4 stores where the quarter is
  // all empty and the cells are 16 slots (64 bytes, so float4-aligned).
  for (int e = threadIdx.x; e < kTileCells * 4; e += kThreads) {
    const int t = e / 4;
    const int s0 = (e % 4) * (kMaxCap / 4);
    const int ta = t / (T::B * T::C);
    const int tb = (t / T::C) % T::B;
    const int tc = t % T::C;
    const int n = tcount[t];
    if (s0 + kMaxCap / 4 <= n || s0 >= cap || a0 + ta >= rows ||
        b0 + tb >= res || c0 + tc >= res)
      continue;
    const size_t o = cell_index<DIM>(a0 + ta, b0 + tb, c0 + tc, res) * cap;
    if (cap == kMaxCap && s0 >= n) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(ax + o)[s0 / 4] = z;
      reinterpret_cast<float4*>(ay + o)[s0 / 4] = z;
      if (DIM == 3) reinterpret_cast<float4*>(az + o)[s0 / 4] = z;
      continue;
    }
    for (int s = max(s0, n); s < min(s0 + kMaxCap / 4, cap); ++s) {
      ax[o + s] = 0.f;
      ay[o + s] = 0.f;
      if (DIM == 3) az[o + s] = 0.f;
    }
  }
  if (one_chunk) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 4. Passes over the compacted targets, each over the chunks.
  const int n_targets = tstart[kTileCells];
  const int nch = one_chunk ? 1 : n_chunks;
  const size_t halo = static_cast<size_t>(rr) * res *
                      (DIM == 3 ? res : 1) * cap;  // window - target index
  for (int t0 = 0; t0 < n_targets; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const bool active = t < n_targets;
    int ta = 0, tb = 0, tc = 0;
    float px0 = 0.f, py0 = 0.f, pz0 = 0.f;
    size_t g = 0;
    if (active) {
      const int code = tgt[t];
      const int cell = code / kMaxCap;
      ta = cell / (T::B * T::C);
      tb = (cell / T::C) % T::B;
      tc = cell % T::C;
      g = cell_index<DIM>(a0 + ta, b0 + tb, c0 + tc, res) * cap +
          code % kMaxCap;
      px0 = bx[g + halo];
      py0 = by[g + halo];
      if (DIM == 3) pz0 = bz[g + halo];
    }
    float accx = 0.f, accy = 0.f, accz = 0.f;
    for (int k = 0; k < nch; ++k) {
      const int lo = one_chunk ? 0 : chunk[k];
      const int hi = one_chunk ? L : chunk[k + 1];
      const int sbase = base[lo];
      if (!one_chunk) {
        if (t0 > 0 || k > 0) __syncthreads();  // the stage is overwritten
        stage_lines<DIM>(stage, off, base, lo, hi, S, LB, a0, b0, c0, rr, res,
                         cap, bx, by, bz, bm);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
      }
      if (!active) continue;
      for (int oa = 0; oa < width; ++oa) {
        for (int ob = 0; ob < (DIM == 3 ? width : 1); ++ob) {
          const int l = (ta + oa) * LB + tb + ob;
          if (l < lo || l >= hi) continue;
          const int* o = off + l * S1;
          const float4* run = stage + (base[l] - sbase);
          const int j1 = o[tc + width];
          float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll 4
          for (int j = o[tc]; j < j1; ++j) {
            const float4 q = run[j];
            const float dx = q.x - px0;
            const float dy = q.y - py0;
            float d_sq = dx * dx + dy * dy;
            float dz = 0.f;
            if (DIM == 3) {
              dz = q.z - pz0;
              d_sq += dz * dz;
            }
            const float inv = rsqrt_ftz(d_sq + eps_sq);
            float w = (DIM == 3 ? q.w : q.z) * (inv * inv * inv);
            if (MASK) w = d_sq > 0.f ? w : 0.f;  // eps = 0: rsqrt(0) = inf
            sx += w * dx;
            sy += w * dy;
            if (DIM == 3) sz += w * dz;
          }
          accx += sx;
          accy += sy;
          accz += sz;
        }
      }
    }
    if (active) {
      ax[g] = accx;
      ay[g] = accy;
      if (DIM == 3) az[g] = accz;
    }
  }
}

// Launch over the whole grid; returns cudaGetLastError().
template <int DIM, bool MASK>
int launch_nearfield(const float* bx, const float* by, const float* bz,
                     const float* bm, const int* counts, float* ax, float* ay,
                     float* az, int rows, int res, int cap, int rr,
                     float eps_sq, cudaStream_t stream) {
  using T = Tile<DIM>;
  const int smem = smem_bytes<DIM>(rr, cap);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nearfield_kernel<DIM, MASK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned tiles_c = (res + T::C - 1) / T::C;
  const unsigned tiles_a = (rows + T::A - 1) / T::A;
  const dim3 grid = DIM == 3
                        ? dim3(tiles_c, (res + T::B - 1) / T::B, tiles_a)
                        : dim3(tiles_c, tiles_a);
  nearfield_kernel<DIM, MASK><<<grid, kThreads, smem, stream>>>(
      bx, by, bz, bm, counts, ax, ay, az, rows, res, cap, rr, eps_sq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
