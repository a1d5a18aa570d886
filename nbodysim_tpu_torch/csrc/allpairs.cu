// K1: exact Plummer-softened all-pairs gravity, f32.
//
// Replaces the TPU kernel nbodysim_tpu/kernels/allpairs.py:_allpairs_kernel
// (and its wrapper allpairs_accelerations). For every target i:
//
//   a_i = sum_j (G m_j) (x_j - x_i) (|x_j - x_i|^2 + eps^2)^(-3/2)
//
// with the d^2 > 0 mask applied only when eps == 0 (otherwise x_j = x_i
// already zeroes the term). Distances come from broadcast subtraction,
// never |x|^2 - 2 x.y, so near-field pairs keep full precision at
// coordinates of ~1e5.
//
// What bounds it on the H100: instruction issue. An SM issues 4 warp-
// instructions a clock (128 thread-instructions), and the inner loop, read
// from the SASS (chip_smoke.py prints it from cuobjdump), is 10.31
// instructions a 2D pair at k = 4 (4 FFMA, 3 FMUL, 2 FADD, one MUFU.RSQ, a
// quarter LDS.128), 10.62 at k = 2 and 13.31 a 3D pair at k = 4. That caps
// 2D pairs at ~12.4 a clock per SM (3.25e12/s at 1.98 GHz), below the MUFU
// pipe's 16 (4.18e12/s, the bound chip_smoke.py states). Measured on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit, the SM clock at 1980 MHz
// throughout: 1M x 1M (2D) in 419 ms, 2.62e12 pairs/s, 81% of that cap;
// N=25k in 0.274 ms; 4096 x 1M in 1.68 ms (2D) and 2.22 ms (3D). The kernel
// it replaced (one target a thread, a dynamic trip count, rsqrtf with its
// denormal fix-up) ran at 1.96e12 pairs/s.
//
// Design:
//  * k targets a thread (template K, 2 or 4): one broadcast LDS.128 of a
//    source feeds k pairs, and the k chains give the scheduler independent
//    work. A block is 8 warps; warp w walks slice w of every staged tile,
//    and the 8 slice totals are added in a fixed order at the end, so the
//    result is deterministic and the block covers only 32 k targets (N=25k
//    still gives 391 blocks at k = 2, ~3 a SM).
//  * Sources are packed as they are staged: float4 (x, y, z, G m) per
//    source, 512 to a tile, and the last tile is padded with inert sources
//    (mass 0 at 1e18 in every coordinate: d^2 ~ 1e36, r^-3 underflows to 0,
//    so the term is 0, not NaN, at eps = 0 too). The inner loop therefore
//    runs a fixed count (64 sources a slice, unrolled by 16) with no bounds
//    test. A separate packing launch would add a device operation to every
//    step of the N=25k path, and cp.async copies bytes as they are, so it
//    could neither fold G in nor turn [S, 2] rows into float4.
//  * Double-buffered staging with one barrier a tile: each thread loads its
//    2 sources of tile t+1 into registers before it computes tile t, and
//    stores them into the other buffer after; the loads' latency hides
//    behind the tile's 64 k pairs.
//  * The reciprocal square root is MUFU.RSQ with denormal inputs flushed
//    (rsqrt.approx.ftz.f32): rsqrtf without -ftz wraps the same MUFU in a
//    3-instruction denormal fix-up, and for d^2 < 1.2e-38 the weight
//    m r^-3 overflows to inf either way, so no result changes.
//  * Each slice sums one tile's 64 terms before adding them to its running
//    total, and that total is compensated (Kahan): at N=1M a slice adds
//    2048 tile sums, and a plain running total drifted ~1e-5 of max|a| from
//    the blocked plain version on the galaxy merger, whose nuclei dominate
//    the sums. Three more adds per tile and axis, against 64 pairs.
//
// Few targets, many sources (the tree code's outliers <- all, 4096 x 1M):
// the caller splits the sources into `splits` contiguous chunks along a
// second grid axis (gridDim.y); each block writes its chunk's partial sums
// to a scratch array [splits, N, D], and a second pass adds the chunks in
// index order. No atomics, so the result stays deterministic. With
// splits == 1 the block writes straight to `out`. The same entry point
// serves K4 (many targets, few sources: the bulk <- outliers coupling),
// which needs no split.
//
// The file also holds the potential's pair sum (potential_kernel, below),
// which the energy diagnostics launch; its note says how it differs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSlices = 8;                   // warps a block, one slice each
constexpr int kThreads = kWarp * kSlices;    // 256
constexpr int kTile = 512;                   // sources staged per pass
constexpr int kPerSlice = kTile / kSlices;   // 64 sources a warp a pass
constexpr int kStage = kTile / kThreads;     // 2 sources a thread a pass
constexpr float kPadPos = 1e18f;             // where padding sources sit

// sum += x with the running compensation c (no --use_fast_math, so nvcc
// keeps the order of these adds).
__device__ __forceinline__ void kahan_add(float& sum, float& c, float x) {
  const float y = x - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Source j packed for the tile: (x, y, z, G m); past the chunk, inert.
template <int DIM>
__device__ __forceinline__ float4 pack_source(const float* __restrict__ src,
                                              const float* __restrict__ mass,
                                              int j, int end, float g) {
  if (j >= end) return make_float4(kPadPos, kPadPos, kPadPos, 0.f);
  float4 q;
  q.x = src[j * DIM];
  q.y = src[j * DIM + 1];
  q.z = DIM == 3 ? src[j * DIM + 2] : 0.f;
  q.w = g * mass[j];  // G folds into the source mass
  return q;
}

template <int DIM, int K, bool MASK>
__global__ void __launch_bounds__(kThreads)
allpairs_kernel(const float* __restrict__ tgt, const float* __restrict__ src,
                const float* __restrict__ src_mass, float* __restrict__ out,
                int n, int s, int chunk, float eps_sq, float g) {
  constexpr int kBlockTargets = kWarp * K;
  __shared__ float4 tile[2][kTile];
  __shared__ float part[kSlices - 1][DIM][kBlockTargets];

  const int lane = threadIdx.x % kWarp;
  const int slice = threadIdx.x / kWarp;
  const int first = blockIdx.x * kBlockTargets + lane;

  // This thread's targets first + 32 k, k < K (coalesced across the warp).
  float xi[K], yi[K], zi[K];
  float ax[K], ay[K], az[K], cx[K], cy[K], cz[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = first + kWarp * k;
    xi[k] = i < n ? tgt[i * DIM] : 0.f;
    yi[k] = i < n ? tgt[i * DIM + 1] : 0.f;
    zi[k] = DIM == 3 && i < n ? tgt[i * DIM + 2] : 0.f;
    ax[k] = ay[k] = az[k] = cx[k] = cy[k] = cz[k] = 0.f;
  }

  // This block's chunk of sources: [s_begin, s_end), chunk a multiple of
  // kTile; blockIdx.y == 0 and chunk >= s without a split.
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(s, s_begin + chunk);
  const int tiles = s_end > s_begin ? (s_end - s_begin + kTile - 1) / kTile
                                    : 0;
  float4 next[kStage];
  if (tiles > 0) {
#pragma unroll
    for (int q = 0; q < kStage; ++q)
      tile[0][threadIdx.x + q * kThreads] = pack_source<DIM>(
          src, src_mass, s_begin + threadIdx.x + q * kThreads, s_end, g);
  }
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const bool more = t + 1 < tiles;
    if (more) {  // tile t+1 into registers; its loads fly during tile t
      const int base = s_begin + (t + 1) * kTile + threadIdx.x;
#pragma unroll
      for (int q = 0; q < kStage; ++q)
        next[q] = pack_source<DIM>(src, src_mass, base + q * kThreads, s_end,
                                   g);
    }
    const float4* sl = tile[t & 1] + slice * kPerSlice;
    float sx[K], sy[K], sz[K];
#pragma unroll
    for (int k = 0; k < K; ++k) sx[k] = sy[k] = sz[k] = 0.f;
#pragma unroll 16
    for (int jj = 0; jj < kPerSlice; ++jj) {
      const float4 q = sl[jj];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float dx = q.x - xi[k];
        const float dy = q.y - yi[k];
        float d_sq = eps_sq + dx * dx + dy * dy;
        float dz = 0.f;
        if (DIM == 3) {
          dz = q.z - zi[k];
          d_sq += dz * dz;
        }
        const float inv = rsqrt_ftz(d_sq);
        float w = q.w * (inv * inv * inv);
        if (MASK) w = d_sq > 0.f ? w : 0.f;  // eps = 0: rsqrt(0) = inf
        sx[k] += w * dx;
        sy[k] += w * dy;
        if (DIM == 3) sz[k] += w * dz;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      kahan_add(ax[k], cx[k], sx[k]);
      kahan_add(ay[k], cy[k], sy[k]);
      if (DIM == 3) kahan_add(az[k], cz[k], sz[k]);
    }
    if (more) {
#pragma unroll
      for (int q = 0; q < kStage; ++q)
        tile[(t + 1) & 1][threadIdx.x + q * kThreads] = next[q];
    }
    // One barrier a tile: buffer (t+1)&1 was last read in pass t-1, which
    // every thread finished before the barrier that ended it.
    __syncthreads();
  }

  if (slice > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      part[slice - 1][0][lane + kWarp * k] = ax[k];
      part[slice - 1][1][lane + kWarp * k] = ay[k];
      if (DIM == 3) part[slice - 1][DIM - 1][lane + kWarp * k] = az[k];
    }
  }
  __syncthreads();
  if (slice == 0) {
    float* o = out + static_cast<size_t>(blockIdx.y) * n * DIM;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = first + kWarp * k;
#pragma unroll
      for (int p = 0; p < kSlices - 1; ++p) {
        ax[k] += part[p][0][lane + kWarp * k];
        ay[k] += part[p][1][lane + kWarp * k];
        if (DIM == 3) az[k] += part[p][DIM - 1][lane + kWarp * k];
      }
      if (i < n) {
        o[i * DIM] = ax[k];
        o[i * DIM + 1] = ay[k];
        if (DIM == 3) o[i * DIM + 2] = az[k];
      }
    }
  }
}

// out[k] = sum_p part[p][k], p in index order (the split's second pass).
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int count,
                                  int splits) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  float a = 0.f;
  for (int p = 0; p < splits; ++p)
    a += part[static_cast<size_t>(p) * count + k];
  out[k] = a;
}

// The exact softened potential's pair sum, for the HUD and the energy
// diagnostics:
//
//   P = sum_i m_i sum_{j, d_ij^2 > 0} m_j (d_ij^2 + eps^2)^(-1/2)
//
// (the caller scales it by -G/2). It replaces no TPU kernel: the JAX
// package sums the potential in plain XLA (nbodysim_tpu/physics/forces.py:
// potential_energy); the port's plain version of that sum, whose blocked
// [2048, 4096] temporaries move ~50 GB of HBM at N=25k, held the viewer's
// HUD at ~30 ms a frame. A sibling of K1 with K1's layout and staging (k
// targets a thread, 8 slices, float4 sources double-buffered 512 to a
// tile, inert padding, rsqrt.approx.ftz); K1 itself stays as it is. The
// mask d^2 > 0 applies at every eps: unlike K1's vector term, the scalar
// term of a self or coincident pair is m/eps, not 0. What bounds it: the
// MUFU pipe (one rsqrt a pair, 4.18e12/s: 0.150 ms at N=25k) and
// instruction issue, 9.62 SASS instructions a 2D pair at k = 2, 9.31 at
// k = 4, 11.31 a 3D pair (3 FADD, 2 FFMA, FMUL, FSETP, FSEL, MUFU.RSQ and a
// share of LDS.128 in 2D). Measured on an NVIDIA H100 80GB HBM3 at 700 W:
// N=25k in ~0.24 ms. The sums: each slice adds a
// tile's 64 terms, then a compensated running total (as K1); a target's
// 8 slice totals meet in double, in slice order, and are multiplied by
// m_i; the block adds its targets in a fixed order (lanes' k in order,
// then a fixed shuffle tree) into one double partial; a second launch adds
// the partials in index order. No atomics, so two calls give the same
// bits. A source split (gridDim.y) only adds partials.
template <int DIM, int K>
__global__ void __launch_bounds__(kThreads)
potential_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
                 double* __restrict__ partial, int n, int chunk,
                 float eps_sq) {
  constexpr int kBlockTargets = kWarp * K;
  __shared__ float4 tile[2][kTile];
  __shared__ double part[kSlices - 1][kBlockTargets];

  const int lane = threadIdx.x % kWarp;
  const int slice = threadIdx.x / kWarp;
  const int first = blockIdx.x * kBlockTargets + lane;

  float xi[K], yi[K], zi[K], phi[K], c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = first + kWarp * k;
    xi[k] = i < n ? pos[i * DIM] : 0.f;
    yi[k] = i < n ? pos[i * DIM + 1] : 0.f;
    zi[k] = DIM == 3 && i < n ? pos[i * DIM + 2] : 0.f;
    phi[k] = c[k] = 0.f;
  }

  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(n, s_begin + chunk);
  const int tiles = s_end > s_begin ? (s_end - s_begin + kTile - 1) / kTile
                                    : 0;
  float4 next[kStage];
  if (tiles > 0) {
#pragma unroll
    for (int q = 0; q < kStage; ++q)
      tile[0][threadIdx.x + q * kThreads] = pack_source<DIM>(
          pos, mass, s_begin + threadIdx.x + q * kThreads, s_end, 1.f);
  }
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const bool more = t + 1 < tiles;
    if (more) {
      const int base = s_begin + (t + 1) * kTile + threadIdx.x;
#pragma unroll
      for (int q = 0; q < kStage; ++q)
        next[q] = pack_source<DIM>(pos, mass, base + q * kThreads, s_end,
                                   1.f);
    }
    const float4* sl = tile[t & 1] + slice * kPerSlice;
    float sp[K];
#pragma unroll
    for (int k = 0; k < K; ++k) sp[k] = 0.f;
#pragma unroll 16
    for (int jj = 0; jj < kPerSlice; ++jj) {
      const float4 q = sl[jj];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float dx = q.x - xi[k];
        const float dy = q.y - yi[k];
        float r_sq = dx * dx + dy * dy;
        if (DIM == 3) {
          const float dz = q.z - zi[k];
          r_sq += dz * dz;
        }
        const float inv = rsqrt_ftz(r_sq + eps_sq);
        sp[k] += q.w * (r_sq > 0.f ? inv : 0.f);  // rsqrt(0) = inf at eps 0
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) kahan_add(phi[k], c[k], sp[k]);
    if (more) {
#pragma unroll
      for (int q = 0; q < kStage; ++q)
        tile[(t + 1) & 1][threadIdx.x + q * kThreads] = next[q];
    }
    __syncthreads();
  }

  // The running total is phi - c (c holds what the last adds overshot).
  if (slice > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      part[slice - 1][lane + kWarp * k] =
          static_cast<double>(phi[k]) - static_cast<double>(c[k]);
  }
  __syncthreads();
  if (slice == 0) {
    double sum = 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = first + kWarp * k;
      double t = static_cast<double>(phi[k]) - static_cast<double>(c[k]);
#pragma unroll
      for (int p = 0; p < kSlices - 1; ++p) t += part[p][lane + kWarp * k];
      if (i < n) sum += static_cast<double>(mass[i]) * t;
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = sum;
  }
}

// *out = sum_p partial[p], p in index order, in double (one thread).
__global__ void sum_partials_kernel(const double* __restrict__ partial,
                                    float* __restrict__ out, int count) {
  double a = 0.0;
  for (int p = 0; p < count; ++p) a += partial[p];
  *out = static_cast<float>(a);
}

template <int DIM, int K>
void launch_potential(const float* pos, const float* mass, double* partial,
                      int n, int splits, int chunk, float eps_sq,
                      cudaStream_t stream) {
  const dim3 grid((n + kWarp * K - 1) / (kWarp * K), splits);
  potential_kernel<DIM, K><<<grid, kThreads, 0, stream>>>(
      pos, mass, partial, n, chunk, eps_sq);
}

template <int DIM, int K>
void launch(const float* tgt, const float* src, const float* src_mass,
            float* dst, int n, int s, int splits, int chunk, float eps_sq,
            float g, cudaStream_t stream) {
  const dim3 grid((n + kWarp * K - 1) / (kWarp * K), splits);
  if (eps_sq == 0.f)
    allpairs_kernel<DIM, K, true><<<grid, kThreads, 0, stream>>>(
        tgt, src, src_mass, dst, n, s, chunk, eps_sq, g);
  else
    allpairs_kernel<DIM, K, false><<<grid, kThreads, 0, stream>>>(
        tgt, src, src_mass, dst, n, s, chunk, eps_sq, g);
}

}  // namespace

extern "C" int nb_sum_splits(const float* part, float* out, int count,
                             int splits, void* stream);

// splits >= 1 source chunks; with splits > 1, `scratch` holds
// splits * n * dim floats. k: targets a thread, 2 or 4 (a block covers
// 32 k targets).
extern "C" int nb_allpairs_accelerations(
    const float* tgt, const float* src, const float* src_mass, float* out,
    float* scratch, int n, int s, int dim, int splits, int k, float eps_sq,
    float g, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || s <= 0 || splits <= 0 || (splits > 1 && scratch == nullptr) ||
      (k != 2 && k != 4) || (dim != 2 && dim != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  // Chunks are whole tiles, so only the last one is ragged.
  const int per = (s + splits - 1) / splits;
  const int chunk = (per + kTile - 1) / kTile * kTile;
  float* dst = splits > 1 ? scratch : out;
  if (dim == 2 && k == 2)
    launch<2, 2>(tgt, src, src_mass, dst, n, s, splits, chunk, eps_sq, g, st);
  else if (dim == 2)
    launch<2, 4>(tgt, src, src_mass, dst, n, s, splits, chunk, eps_sq, g, st);
  else if (k == 2)
    launch<3, 2>(tgt, src, src_mass, dst, n, s, splits, chunk, eps_sq, g, st);
  else
    launch<3, 4>(tgt, src, src_mass, dst, n, s, splits, chunk, eps_sq, g, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return nb_sum_splits(scratch, out, n * dim, splits, stream);
}

// *out = sum_{i != j} m_i m_j (d_ij^2 + eps^2)^(-1/2) over pairs with
// d_ij^2 > 0, f32. `partial` holds ceil(n / (32 k)) * splits doubles;
// k: targets a thread, 2 or 4.
extern "C" int nb_allpairs_potential(const float* pos, const float* mass,
                                     double* partial, float* out, int n,
                                     int dim, int splits, int k,
                                     float eps_sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || splits <= 0 || partial == nullptr || (k != 2 && k != 4) ||
      (dim != 2 && dim != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (n + splits - 1) / splits;
  const int chunk = (per + kTile - 1) / kTile * kTile;
  if (dim == 2 && k == 2)
    launch_potential<2, 2>(pos, mass, partial, n, splits, chunk, eps_sq, st);
  else if (dim == 2)
    launch_potential<2, 4>(pos, mass, partial, n, splits, chunk, eps_sq, st);
  else if (k == 2)
    launch_potential<3, 2>(pos, mass, partial, n, splits, chunk, eps_sq, st);
  else
    launch_potential<3, 4>(pos, mass, partial, n, splits, chunk, eps_sq, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kWarp * k - 1) / (kWarp * k);
  sum_partials_kernel<<<1, 1, 0, st>>>(partial, out, blocks * splits);
  return static_cast<int>(cudaGetLastError());
}

// out[k] = sum_p part[p * count + k] for k < count, p in index order: the
// second pass of a source split (K1, K4 and K5).
extern "C" int nb_sum_splits(const float* part, float* out, int count,
                             int splits, void* stream) {
  if (count <= 0 || splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sum_splits_kernel<<<(count + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(part, out, count,
                                                           splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nb_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
