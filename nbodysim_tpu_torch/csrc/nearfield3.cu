// K7: the octree's near field on a dense 3D bucket grid, f32.
//
// Replaces the TPU kernel nbodysim_tpu/kernels/nearfield.py:_nearfield3_kernel
// (wrapper bucket_stencil3_pallas_flat, layout class _FlatLayout3). Input is
// the bucket grid of physics/barneshut3d.py: bx, by, bz, bm of shape
// [rows + 2rr, res, res, K] (K slots per finest cell, empty slots with mass
// 0, rr halo x-slabs before and after the `rows` target slabs). For every
// slot (i, j, k, s) of the target slabs and every slot of the (2rr+1)^3
// cells around it:
//
//   a += m_s (x_s - x_t) (|x_s - x_t|^2 + eps^2)^(-3/2)
//
// unscaled by G; output ax, ay, az of shape [rows, res, res, K]. Cells past
// the grid's y and z edges are masked by index (x comes in padded). The
// d^2 > 0 mask is applied only when eps == 0, as the plain version does: an
// empty slot sits at the origin, so without it eps = 0 would give 0 * inf.
//
// What bounds it on the H100: at the N = 1M cube (64^3 cells, ~4 bodies a
// cell, rr = 1) the pairs the data needs, ~1.1e8, take ~0.027 ms at one MUFU
// rsqrt each (16/clk/SM, ~4.2e12/s), and reading the four input grids once
// and writing the three outputs ~0.035 ms at 3.35 TB/s: bytes bind, barely.
// The TPU kernel's slot-major [K, F] layout, 128-aligned pitches, lead margin
// and static column shifts served its DMA alignment and are not carried over.
//
// Design: K3's, one dimension up. One thread per target (cell, slot); a
// block covers 4 x 4 x 4 target cells x K slots (1,024 threads at K = 16).
// Its source cube, the cells plus an rr-cell halo on every side, is
// (4 + 2rr)^3 cells: 55 KB of float4 (x, y, z, m) at rr = 1, 131 KB at
// rr = 2, and too large for shared memory at rr = 3-4 (256 KB, 442 KB). So
// the cube is staged in chunks of whole x-planes, as many planes a chunk as
// fit a 112 KB budget (two blocks an SM): all 6 planes at once at rr = 1,
// 6 + 2 at rr = 2, 4 at a time at rr = 3, 3 at rr = 4. A target at cube
// plane tx + rr
// reads source planes tx .. tx + 2rr; chunks run in x order, so every
// thread still adds its offsets in (ox, oy, oz) order -- the plain version's
// order, with each offset's slots summed before the offset is added -- with
// no atomics, so the result is deterministic. The 16 threads of a cell read
// the same source slot (a broadcast), so a warp (two cells) reads two float4
// per pair. Slots fill from 0 in the force path and a slot of mass 0 adds
// exactly 0, so each staged cell records 1 + its last slot of nonzero mass
// and the loop over a source cell stops there: the kernel evaluates the
// occupied source slots only, for every target slot (empty targets included,
// so the output matches the plain version everywhere). Offsets into the grid
// are size_t (128^3 cells x 16 slots at the deepest level).

#include <cuda_runtime.h>

namespace {

constexpr int kCells = 4;    // target cells per block side
constexpr int kMaxCap = 16;  // slots per cell (threads: kCells^3 * cap)
constexpr int kMaxRR = 4;    // halo cells (acceptance radius <= 5)
constexpr int kSmemBudget = 112 * 1024;  // two 1,024-thread blocks an SM

template <bool MASK>
__global__ void __launch_bounds__(kCells * kCells * kCells * kMaxCap)
nearfield3_kernel(const float* __restrict__ bx, const float* __restrict__ by,
                  const float* __restrict__ bz, const float* __restrict__ bm,
                  float* __restrict__ ax, float* __restrict__ ay,
                  float* __restrict__ az, int rows, int res, int cap, int rr,
                  int chunk, float eps_sq) {
  const int side = kCells + 2 * rr;           // cube side, in cells
  const int face = side * side;               // cells of one x-plane
  extern __shared__ float4 tile[];            // [chunk * face * cap]
  int* occupied = reinterpret_cast<int*>(tile + chunk * face * cap);

  const int tiles_z = (res + kCells - 1) / kCells;
  const int y_first = (blockIdx.x / tiles_z) * kCells;  // first target y
  const int z_first = (blockIdx.x % tiles_z) * kCells;  // first target z
  const int x0 = blockIdx.y * kCells;   // window slab of cube plane 0
  const int rows_w = rows + 2 * rr;
  const int tid = threadIdx.x;

  const int slot = tid % cap;
  const int tcell = tid / cap;
  const int tx = tcell / (kCells * kCells);
  const int ty = (tcell / kCells) % kCells;
  const int tz = tcell % kCells;
  const int ti = x0 + tx;                     // target slab (0..rows)
  const int tj = y_first + ty;
  const int tk = z_first + tz;
  const bool live = ti < rows && tj < res && tk < res;

  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const size_t g =
        ((static_cast<size_t>(ti + rr) * res + tj) * res + tk) * cap + slot;
    t.x = bx[g];
    t.y = by[g];
    t.z = bz[g];
  }

  float accx = 0.f, accy = 0.f, accz = 0.f;
  for (int p0 = 0; p0 < side; p0 += chunk) {
    const int planes = min(chunk, side - p0);
    const int n_stage = planes * face * cap;
    for (int e = tid; e < n_stage; e += blockDim.x) {
      const int cell = e / cap;
      const int x = x0 + p0 + cell / face;
      const int y = y_first - rr + (cell % face) / side;
      const int z = z_first - rr + cell % side;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (x < rows_w && y >= 0 && y < res && z >= 0 && z < res) {
        const size_t g =
            ((static_cast<size_t>(x) * res + y) * res + z) * cap + e % cap;
        q.x = bx[g];
        q.y = by[g];
        q.z = bz[g];
        q.w = bm[g];
      }
      tile[e] = q;
    }
    __syncthreads();
    for (int cell = tid; cell < planes * face; cell += blockDim.x) {
      int count = 0;
      for (int k = 0; k < cap; ++k)
        if (tile[cell * cap + k].w != 0.f) count = k + 1;
      occupied[cell] = count;
    }
    __syncthreads();

    // Source planes p0 .. p0 + planes - 1 of the cube; this target reads
    // planes tx .. tx + 2rr, i.e. ox = plane - tx.
    const int ox_lo = max(0, p0 - tx);
    const int ox_hi = min(2 * rr, p0 + planes - 1 - tx);
    for (int ox = ox_lo; ox <= ox_hi; ++ox) {
      const int plane = tx + ox - p0;
      for (int oy = 0; oy <= 2 * rr; ++oy) {
        for (int oz = 0; oz <= 2 * rr; ++oz) {
          const int sc = (plane * side + ty + oy) * side + tz + oz;
          const float4* src = tile + sc * cap;
          const int count = occupied[sc];
          float px = 0.f, py = 0.f, pz = 0.f;
          for (int k = 0; k < count; ++k) {
            const float4 q = src[k];
            const float dx = q.x - t.x;
            const float dy = q.y - t.y;
            const float dz = q.z - t.z;
            const float d_sq = dx * dx + dy * dy + dz * dz;
            const float inv = rsqrtf(d_sq + eps_sq);
            float w = q.w * (inv * inv * inv);
            if (MASK) w = d_sq > 0.f ? w : 0.f;  // eps = 0: rsqrt(0) = inf
            px += w * dx;
            py += w * dy;
            pz += w * dz;
          }
          accx += px;
          accy += py;
          accz += pz;
        }
      }
    }
    __syncthreads();   // the next chunk overwrites the tile
  }
  if (live) {
    const size_t o =
        ((static_cast<size_t>(ti) * res + tj) * res + tk) * cap + slot;
    ax[o] = accx;
    ay[o] = accy;
    az[o] = accz;
  }
}

template <bool MASK>
int launch(const float* bx, const float* by, const float* bz,
           const float* bm, float* ax, float* ay, float* az, int rows,
           int res, int cap, int rr, float eps_sq, cudaStream_t stream) {
  const int side = kCells + 2 * rr;
  const int plane_bytes = side * side *
      (cap * static_cast<int>(sizeof(float4)) + static_cast<int>(sizeof(int)));
  const int chunk = max(1, min(side, kSmemBudget / plane_bytes));
  const int smem = chunk * plane_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nearfield3_kernel<MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (res + kCells - 1) / kCells;
  const dim3 grid(tiles * tiles, (rows + kCells - 1) / kCells);
  nearfield3_kernel<MASK>
      <<<grid, kCells * kCells * kCells * cap, smem, stream>>>(
          bx, by, bz, bm, ax, ay, az, rows, res, cap, rr, chunk, eps_sq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nb_bucket_stencil3(const float* bx, const float* by,
                                  const float* bz, const float* bm, float* ax,
                                  float* ay, float* az, int rows, int res,
                                  int cap, int rr, float eps_sq,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (res + kCells - 1) / kCells;
  if (rows <= 0 || res <= 0 || cap <= 0 || cap > kMaxCap || rr < 0 ||
      rr > kMaxRR || tiles * tiles > 2147483647LL ||
      (rows + kCells - 1) / kCells > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (eps_sq == 0.f)
    return launch<true>(bx, by, bz, bm, ax, ay, az, rows, res, cap, rr,
                        eps_sq, st);
  return launch<false>(bx, by, bz, bm, ax, ay, az, rows, res, cap, rr,
                       eps_sq, st);
}
