// K7: the octree's near field on a dense 3D bucket grid, f32.
//
// Replaces the TPU kernel nbodysim_tpu/kernels/nearfield.py:_nearfield3_kernel
// (wrapper bucket_stencil3_pallas_flat, layout class _FlatLayout3). Input is
// the bucket grid of physics/barneshut3d.py: bx, by, bz, bm of shape
// [rows + 2rr, res, res, K] (K slots per finest cell, rr halo x-slabs before
// and after the `rows` target slabs) and counts [rows + 2rr, res, res]
// int32, each cell's occupied slots (slots from `count` up are empty, mass
// 0). For every slot (i, j, k, s) with s < count of the target slabs, and
// every occupied slot of the (2rr+1)^3 cells around it:
//
//   a += m_s (x_s - x_t) (|x_s - x_t|^2 + eps^2)^(-3/2)
//
// unscaled by G; output ax, ay, az of shape [rows, res, res, K], exactly 0
// at the slots at or above each cell's count. Cells past the grid's y and z
// edges are masked by index (x comes in padded). The d^2 > 0 mask is
// applied only when eps == 0, as the plain version does.
//
// What bounds it on the H100: at the N = 1M cube (64^3 cells, ~4 bodies a
// cell, rr = 1) the pairs the data needs, ~1.1e8, take ~0.031 ms at 19 f32
// operations each (67 TFLOP/s) and ~0.026 ms at one MUFU rsqrt each
// (16/clk/SM, 4.18e12/s); reading the occupied slots and counts once and
// writing the three outputs takes ~0.020 ms at 3.35 TB/s: operations bind.
// The TPU kernel's slot-major [K, F] layout, 128-aligned pitches, lead
// margin and static column shifts served its DMA alignment and are not
// carried over.
//
// Design (nearfield_tile.cuh, shared with K3): threads on the occupied
// target slots only, sources staged compacted per (x, y) line along z, so a
// target sums (2rr+1)^2 contiguous runs of ~(2rr+1) x 4 sources; chunks of
// whole lines keep any rr (1-4) and full cells within 32 KB of staged
// sources. Offsets into the grid are size_t (128^3 cells x 16 slots at the
// deepest level).

#include "nearfield_tile.cuh"

extern "C" int nb_bucket_stencil3(const float* bx, const float* by,
                                  const float* bz, const float* bm,
                                  const int* counts, float* ax, float* ay,
                                  float* az, int rows, int res, int cap,
                                  int rr, float eps_sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || res <= 0 || cap <= 0 || cap > kMaxCap || rr < 0 ||
      rr > kMaxRR || (res + Tile<3>::B - 1) / Tile<3>::B > 65535 ||
      (rows + Tile<3>::A - 1) / Tile<3>::A > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (eps_sq == 0.f)
    return launch_nearfield<3, true>(bx, by, bz, bm, counts, ax, ay, az,
                                     rows, res, cap, rr, eps_sq, st);
  return launch_nearfield<3, false>(bx, by, bz, bm, counts, ax, ay, az, rows,
                                    res, cap, rr, eps_sq, st);
}

