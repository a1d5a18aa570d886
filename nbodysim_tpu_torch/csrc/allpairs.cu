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
// What bounds it on the H100: arithmetic, not bytes. A pair costs ~10 f32
// FP ops (2-3 sub, 2-3 fma, 3 mul, 2-3 fma) plus one MUFU rsqrt, and the
// MUFU pipe (16 ops/clk/SM against 128 FP32 lanes) is the first ceiling;
// each source is read from device memory once per block of 64 targets.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit: 1.95e12
// pairs/s at N=1M, about half the MUFU bound (132 x 16 x ~1.98 GHz = 4.2e12),
// so the issue rate of the FP ops and the shared-memory load binds first.
// Design: one thread per (target, source slice). A block is 64 targets x 4
// source slices; all 256 threads stage 256 sources (x, y, z, G*m) into
// shared memory per pass as one float4 each, and each thread walks its own
// 64-entry slice of the tile, so a warp reads one broadcast float4 per pair.
// Splitting the sources four ways fills the 132 SMs at the main path's
// N=25k (391 blocks of 256 threads rather than 98 blocks of 256 targets).
// The four slice sums are added in a fixed order at the end, so the result
// is deterministic. Each slice sums one tile (64 terms) before adding it to
// its running total, which keeps the f32 summation error near that of the
// blocked plain version. The ragged last tile is masked by index.
//
// Few targets, many sources (the tree code's outliers <- all, 4096 x 1M):
// 64 blocks would leave half of the 132 SMs idle. The caller then splits
// the sources into `splits` contiguous chunks along a second grid axis
// (gridDim.y); each block writes its chunk's partial sums to a scratch
// array [splits, N, D], and a second pass adds the chunks in index order.
// No atomics, so the result stays deterministic. With splits == 1 the
// block writes straight to `out`. The same entry point serves K4 (many
// targets, few sources: the bulk <- outliers coupling), which needs no
// split.

#include <cuda_runtime.h>

namespace {

constexpr int kTargets = 64;   // targets per block (blockDim.x)
constexpr int kSlices = 4;     // source slices per block (blockDim.y)
constexpr int kTile = kTargets * kSlices;

template <int DIM, bool MASK>
__global__ void __launch_bounds__(kTile)
allpairs_kernel(const float* __restrict__ tgt, const float* __restrict__ src,
                const float* __restrict__ src_mass, float* __restrict__ out,
                int n, int s, int chunk, float eps_sq, float g) {
  __shared__ float4 tile[kTile];
  __shared__ float part[kSlices - 1][DIM][kTargets];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int lane = ty * kTargets + tx;
  const int i = blockIdx.x * kTargets + tx;

  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < n) {
    xi = tgt[i * DIM];
    yi = tgt[i * DIM + 1];
    if (DIM == 3) zi = tgt[i * DIM + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;

  // This block's chunk of sources: [s_begin, s_end), chunk a multiple of
  // kTile; blockIdx.y == 0 and chunk >= s without a split.
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(s, s_begin + chunk);
  for (int base = s_begin; base < s_end; base += kTile) {
    const int j = base + lane;
    if (j < s_end) {
      float4 q;
      q.x = src[j * DIM];
      q.y = src[j * DIM + 1];
      q.z = DIM == 3 ? src[j * DIM + 2] : 0.f;
      q.w = g * src_mass[j];  // G folds into the source mass
      tile[lane] = q;
    }
    __syncthreads();
    const int count = min(kTargets, s_end - base - ty * kTargets);
    const float4* slice = tile + ty * kTargets;
    float tx_sum = 0.f, ty_sum = 0.f, tz_sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < count; ++k) {
      const float4 q = slice[k];
      const float dx = q.x - xi;
      const float dy = q.y - yi;
      float d_sq = eps_sq + dx * dx + dy * dy;
      float dz = 0.f;
      if (DIM == 3) {
        dz = q.z - zi;
        d_sq += dz * dz;
      }
      const float inv = rsqrtf(d_sq);
      float w = q.w * (inv * inv * inv);
      if (MASK) w = d_sq > 0.f ? w : 0.f;  // eps = 0: rsqrt(0) = inf
      tx_sum += w * dx;
      ty_sum += w * dy;
      if (DIM == 3) tz_sum += w * dz;
    }
    ax += tx_sum;
    ay += ty_sum;
    az += tz_sum;
    __syncthreads();
  }

  if (ty > 0) {
    part[ty - 1][0][tx] = ax;
    part[ty - 1][1][tx] = ay;
    if (DIM == 3) part[ty - 1][DIM - 1][tx] = az;
  }
  __syncthreads();
  if (ty == 0 && i < n) {
#pragma unroll
    for (int p = 0; p < kSlices - 1; ++p) {
      ax += part[p][0][tx];
      ay += part[p][1][tx];
      if (DIM == 3) az += part[p][DIM - 1][tx];
    }
    float* o = out + static_cast<size_t>(blockIdx.y) * n * DIM;
    o[i * DIM] = ax;
    o[i * DIM + 1] = ay;
    if (DIM == 3) o[i * DIM + 2] = az;
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

template <int DIM, bool MASK>
void launch(const float* tgt, const float* src, const float* src_mass,
            float* dst, int n, int s, int splits, int chunk, float eps_sq,
            float g, cudaStream_t stream) {
  const dim3 block(kTargets, kSlices);
  const dim3 grid((n + kTargets - 1) / kTargets, splits);
  allpairs_kernel<DIM, MASK><<<grid, block, 0, stream>>>(
      tgt, src, src_mass, dst, n, s, chunk, eps_sq, g);
}

}  // namespace

// splits >= 1 source chunks; with splits > 1, `scratch` holds
// splits * n * dim floats.
extern "C" int nb_allpairs_accelerations(
    const float* tgt, const float* src, const float* src_mass, float* out,
    float* scratch, int n, int s, int dim, int splits, float eps_sq, float g,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mask = eps_sq == 0.f;
  if (n <= 0 || s <= 0 || splits <= 0 || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // Chunks are whole tiles, so only the last one is ragged.
  const int per = (s + splits - 1) / splits;
  const int chunk = (per + kTile - 1) / kTile * kTile;
  float* dst = splits > 1 ? scratch : out;
  if (dim == 2) {
    if (mask) launch<2, true>(tgt, src, src_mass, dst, n, s, splits, chunk,
                              eps_sq, g, st);
    else launch<2, false>(tgt, src, src_mass, dst, n, s, splits, chunk,
                          eps_sq, g, st);
  } else if (dim == 3) {
    if (mask) launch<3, true>(tgt, src, src_mass, dst, n, s, splits, chunk,
                              eps_sq, g, st);
    else launch<3, false>(tgt, src, src_mass, dst, n, s, splits, chunk,
                          eps_sq, g, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int count = n * dim;
    sum_splits_kernel<<<(count + 255) / 256, 256, 0, st>>>(scratch, out, count,
                                                           splits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nb_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
