// K2: dense all-pairs Jacobi collision narrow phase, f32.
//
// Replaces the TPU kernel nbodysim_tpu/kernels/collide.py:_collide_kernel
// (wrapper allpairs_collision_deltas). For every target i it sums, over all
// sources j with d^2 <= (r_i + r_j)^2 and m_j > 0 (d = x_j - x_i,
// v = v_j - v_i, w1 = m_j / (m_i + m_j)):
//
//   separating  (d.v >= 0, d^2 > 0): dpos_i -= d (r/|d| - 1) w1
//   approaching (d.v < 0):           time-of-impact rewind t, then
//                                    dvel_i += d' (1.5 (d'.v)/|d'|^2) w1,
//                                    dpos_i += that * t,   d' = d - v t
//
// Self pairs (d = v = 0) fall out of both branch conditions; no index mask
// is needed, and coincident distinct particles behave as in the reference
// code. Zero-mass sources never overlap.
//
// What bounds it on the H100: the overlap test, ~8 f32 ops per pair, since
// overlaps are rare (~1e-3 of pairs on the disc); the resolve branch costs
// ~4x the test but runs only for overlapping pairs. Measured on an NVIDIA
// H100 80GB HBM3 at a 700 W power limit: 1.31e12 pairs/s on the N=25k disc
// (where no pair overlaps), below K1: each pair reads two float4 from shared
// memory and builds d^2 without FMA. Design: the skeleton of
// K1 (64 targets x 4 source slices per block, sources staged through shared
// memory as two float4 per source: x, y, z, m and vx, vy, vz, r). A per-pair
// branch takes the place of the TPU kernel's per-tile skip; a warp pays for
// it only when one of its 32 targets overlaps the source in hand. The cell
// sort that the TPU wrapper applied to make its tile skip fire is not done
// (a per-pair branch does not need it; see PERF.md for the measurement).
//
// d^2, d.v and |v|^2 are computed with explicitly rounded products and sums
// (no fused multiply-add), in the same order as the plain torch version, so
// that the discontinuous branch decisions (overlap, separating/approaching)
// agree bit for bit with it on the same inputs.

#include <cuda_runtime.h>

namespace {

constexpr int kTargets = 64;
constexpr int kSlices = 4;
constexpr int kTile = kTargets * kSlices;

template <int DIM>
__device__ __forceinline__ float dot_rn(const float* a, const float* b) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int c = 1; c < DIM; ++c) s = __fadd_rn(s, __fmul_rn(a[c], b[c]));
  return s;
}

template <int DIM>
__global__ void __launch_bounds__(kTile)
collide_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
               const float* __restrict__ mass,
               const float* __restrict__ radius, float* __restrict__ dpos,
               float* __restrict__ dvel, int n, float impulse) {
  __shared__ float4 tile_p[kTile];  // x, y, z, m
  __shared__ float4 tile_v[kTile];  // vx, vy, vz, r
  __shared__ float part[kSlices - 1][2 * DIM][kTargets];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int lane = ty * kTargets + tx;
  const int i = blockIdx.x * kTargets + tx;

  float pi[DIM], vi[DIM], mi = 0.f, ri = 0.f;
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    pi[c] = i < n ? pos[i * DIM + c] : 0.f;
    vi[c] = i < n ? vel[i * DIM + c] : 0.f;
  }
  if (i < n) {
    mi = mass[i];
    ri = radius[i];
  }
  float acc_p[DIM], acc_v[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) acc_p[c] = acc_v[c] = 0.f;

  for (int base = 0; base < n; base += kTile) {
    const int j = base + lane;
    if (j < n) {
      float4 p, v;
      p.x = pos[j * DIM];
      p.y = pos[j * DIM + 1];
      p.z = DIM == 3 ? pos[j * DIM + 2] : 0.f;
      p.w = mass[j];
      v.x = vel[j * DIM];
      v.y = vel[j * DIM + 1];
      v.z = DIM == 3 ? vel[j * DIM + 2] : 0.f;
      v.w = radius[j];
      tile_p[lane] = p;
      tile_v[lane] = v;
    }
    __syncthreads();
    const int count = min(kTargets, n - base - ty * kTargets);
    const int first = ty * kTargets;
    for (int k = 0; k < count; ++k) {
      const float4 p = tile_p[first + k];
      const float sp[3] = {p.x, p.y, p.z};
      float d[DIM];
#pragma unroll
      for (int c = 0; c < DIM; ++c) d[c] = __fsub_rn(sp[c], pi[c]);
      const float d_sq = dot_rn<DIM>(d, d);
      const float4 q = tile_v[first + k];
      const float r = __fadd_rn(ri, q.w);
      const float r_sq = __fmul_rn(r, r);
      if (!(d_sq <= r_sq && p.w > 0.f)) continue;

      const float sv[3] = {q.x, q.y, q.z};
      float v[DIM];
#pragma unroll
      for (int c = 0; c < DIM; ++c) v[c] = __fsub_rn(sv[c], vi[c]);
      const float d_dot_v = dot_rn<DIM>(d, v);
      const float v_sq = dot_rn<DIM>(v, v);
      const float msum = mi + p.w;
      const float w1 = p.w / (msum > 0.f ? msum : 1.f);

      if (d_dot_v >= 0.f && d_sq > 0.f) {
        // Separating: positional de-penetration.
        const float coef = (r / sqrtf(d_sq) - 1.f) * w1;
#pragma unroll
        for (int c = 0; c < DIM; ++c) acc_p[c] -= d[c] * coef;
      } else if (d_dot_v < 0.f) {
        // Approaching: time-of-impact rewind + impulse (hpp:320-346).
        const float safe_v_sq = v_sq > 0.f ? v_sq : 1.f;
        const float disc =
            fmaxf(d_dot_v * d_dot_v - v_sq * (d_sq - r_sq), 0.f);
        const float t = (d_dot_v + sqrtf(disc)) / safe_v_sq;
        float dn[DIM];
        float dn_sq = 0.f, dn_v = 0.f;
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          dn[c] = d[c] - v[c] * t;
          dn_sq += dn[c] * dn[c];
          dn_v += dn[c] * v[c];
        }
        const float scale =
            impulse * dn_v / (dn_sq > 0.f ? dn_sq : 1.f);
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          const float dv = dn[c] * scale * w1;
          acc_v[c] += dv;
          acc_p[c] += dv * t;
        }
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
    for (int s = 0; s < kSlices - 1; ++s) {
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        acc_p[c] += part[s][c][tx];
        acc_v[c] += part[s][DIM + c][tx];
      }
    }
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      dpos[i * DIM + c] = acc_p[c];
      dvel[i * DIM + c] = acc_v[c];
    }
  }
}

template <int DIM>
void launch(const float* pos, const float* vel, const float* mass,
            const float* radius, float* dpos, float* dvel, int n,
            float impulse, cudaStream_t stream) {
  const dim3 block(kTargets, kSlices);
  const dim3 grid((n + kTargets - 1) / kTargets);
  collide_kernel<DIM><<<grid, block, 0, stream>>>(
      pos, vel, mass, radius, dpos, dvel, n, impulse);
}

}  // namespace

extern "C" int nb_collision_deltas(
    const float* pos, const float* vel, const float* mass,
    const float* radius, float* dpos, float* dvel, int n, int dim,
    float impulse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dim == 2) {
    launch<2>(pos, vel, mass, radius, dpos, dvel, n, impulse, st);
  } else if (dim == 3) {
    launch<3>(pos, vel, mass, radius, dpos, dvel, n, impulse, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
