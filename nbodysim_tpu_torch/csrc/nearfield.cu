// K3: the tree code's near field on a dense 2D bucket grid, f32.
//
// Replaces the TPU kernel nbodysim_tpu/kernels/nearfield.py:_nearfield_kernel
// (wrappers bucket_stencil_pallas_flat and bucket_stencil_pallas). Input is
// the bucket grid of physics/barneshut.py: bx, by, bm of shape
// [rows + 2rr, res, K] (K slots per finest cell, rr halo rows above and
// below the `rows` target rows) and counts [rows + 2rr, res] int32, each
// cell's occupied slots (slots from `count` up are empty, mass 0). For every
// slot (i, c, k) with k < count of the target rows, and every occupied slot
// of the (2rr+1)^2 cells around it:
//
//   a += m_s (x_s - x_t) (|x_s - x_t|^2 + eps^2)^(-3/2)
//
// unscaled by G; output ax, ay of shape [rows, res, K], exactly 0 at the
// slots at or above each cell's count. Columns past the grid edge are
// masked by index (rows come in padded). The d^2 > 0 mask is applied only
// when eps == 0, as barneshut._bucket_stencil does.
//
// What bounds it on the H100: at the N = 1M uniform square (512^2 cells,
// ~4 bodies a cell, rr = 2) the pairs the data needs, ~1.0e8, take ~0.025
// ms at one MUFU rsqrt each (16/clk/SM, 4.18e12/s); reading the occupied
// slots and counts once and writing the two outputs takes ~0.014 ms at
// 3.35 TB/s. The TPU kernel's slot-major [K, F] layout, 128-aligned stride
// and lead margin served its DMA alignment and are not carried over.
//
// Design (nearfield_tile.cuh, shared with K7): threads on the occupied
// target slots only, sources staged compacted per row of cells, so a target
// sums 2rr + 1 contiguous runs of ~(2rr+1) x 4 sources.

#include "nearfield_tile.cuh"

extern "C" int nb_bucket_stencil(const float* bx, const float* by,
                                 const float* bm, const int* counts,
                                 float* ax, float* ay, int rows, int res,
                                 int cap, int rr, float eps_sq,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || res <= 0 || cap <= 0 || cap > kMaxCap || rr < 0 ||
      rr > kMaxRR || (rows + Tile<2>::A - 1) / Tile<2>::A > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (eps_sq == 0.f)
    return launch_nearfield<2, true>(bx, by, nullptr, bm, counts, ax, ay,
                                     nullptr, rows, res, cap, rr, eps_sq, st);
  return launch_nearfield<2, false>(bx, by, nullptr, bm, counts, ax, ay,
                                    nullptr, rows, res, cap, rr, eps_sq, st);
}

// The near-field tile, cells along each grid axis (innermost last; 2D: 1 in
// the middle), into shape[0..2]: for callers that model the kernels' warp
// mapping from the grid's occupancy.
extern "C" int nb_nearfield_tile(int dim, int* shape) {
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  shape[0] = dim == 2 ? Tile<2>::A : Tile<3>::A;
  shape[1] = dim == 2 ? Tile<2>::B : Tile<3>::B;
  shape[2] = dim == 2 ? Tile<2>::C : Tile<3>::C;
  return 0;
}
