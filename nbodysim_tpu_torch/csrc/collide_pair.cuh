// The collision narrow phase of one candidate pair, shared by K2/K5
// (collide.cu) and K6 (collide_block.cu).
//
// For target i and source j (d = x_j - x_i, v = v_j - v_i, r = r_i + r_j,
// w1 = m_j / (m_i + m_j)), when d^2 <= r^2:
//
//   separating  (d.v >= 0, d^2 > 0): dpos_i -= d (r/|d| - 1) w1
//   approaching (d.v < 0):           time-of-impact rewind t, then
//                                    dvel_i += d' (impulse (d'.v)/|d'|^2) w1,
//                                    dpos_i += that * t,   d' = d - v t
//
// Self pairs (d = v = 0) fall out of both branch conditions. Sources of
// zero mass never overlap (tested beside d^2 <= r^2, after the distance, as
// K2 always tested it). The caller applies its other masks (cells,
// coverage, rows) before the call.
//
// d^2, d.v, |v|^2 and r^2 are computed with explicitly rounded products and
// sums (no fused multiply-add), in the column order of the plain torch
// version (`kernels/collide._dot`), so that the discontinuous decisions
// (overlap, separating/approaching) agree bit for bit with it on the same
// inputs.

#pragma once

#include <cuda_runtime.h>

namespace nb_collide {

template <int DIM>
__device__ __forceinline__ float dot_rn(const float* a, const float* b) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int c = 1; c < DIM; ++c) s = __fadd_rn(s, __fmul_rn(a[c], b[c]));
  return s;
}

// sp, sv: the source's position and velocity (3 floats; z unused in 2D).
template <int DIM>
__device__ __forceinline__ void collide_pair(
    const float* pi, const float* vi, float mi, float ri, const float* sp,
    const float* sv, float sm, float sr, float impulse, float* acc_p,
    float* acc_v) {
  float d[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) d[c] = __fsub_rn(sp[c], pi[c]);
  const float d_sq = dot_rn<DIM>(d, d);
  const float r = __fadd_rn(ri, sr);
  const float r_sq = __fmul_rn(r, r);
  if (!(d_sq <= r_sq && sm > 0.f)) return;

  float v[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) v[c] = __fsub_rn(sv[c], vi[c]);
  const float d_dot_v = dot_rn<DIM>(d, v);
  const float v_sq = dot_rn<DIM>(v, v);
  const float msum = mi + sm;
  const float w1 = sm / (msum > 0.f ? msum : 1.f);

  if (d_dot_v >= 0.f && d_sq > 0.f) {
    // Separating: positional de-penetration.
    const float coef = (r / sqrtf(d_sq) - 1.f) * w1;
#pragma unroll
    for (int c = 0; c < DIM; ++c) acc_p[c] -= d[c] * coef;
  } else if (d_dot_v < 0.f) {
    // Approaching: time-of-impact rewind + impulse (hpp:320-346).
    const float safe_v_sq = v_sq > 0.f ? v_sq : 1.f;
    const float disc = fmaxf(d_dot_v * d_dot_v - v_sq * (d_sq - r_sq), 0.f);
    const float t = (d_dot_v + sqrtf(disc)) / safe_v_sq;
    float dn[DIM];
    float dn_sq = 0.f, dn_v = 0.f;
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      dn[c] = d[c] - v[c] * t;
      dn_sq += dn[c] * dn[c];
      dn_v += dn[c] * v[c];
    }
    const float scale = impulse * dn_v / (dn_sq > 0.f ? dn_sq : 1.f);
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      const float dv = dn[c] * scale * w1;
      acc_v[c] += dv;
      acc_p[c] += dv * t;
    }
  }
}

// a - b on int32 with two's-complement wrap-around, as torch and XLA compute
// it (signed overflow is undefined in C++, unsigned is not).
__device__ __forceinline__ int sub_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int abs_wrap(int a) {
  const unsigned u = static_cast<unsigned>(a);
  return static_cast<int>(a < 0 ? 0u - u : u);
}

}  // namespace nb_collide
