// K3: the tree code's near field on a dense bucket grid, f32.
//
// Replaces the TPU kernel nbodysim_tpu/kernels/nearfield.py:_nearfield_kernel
// (wrappers bucket_stencil_pallas_flat and bucket_stencil_pallas). Input is
// the bucket grid of physics/barneshut.py: bx, by, bm of shape
// [rows + 2rr, res, K] (K slots per finest cell, empty slots with mass 0,
// rr halo rows above and below the `rows` target rows). For every slot
// (i, c, k) of the target rows and every slot of the (2rr+1)^2 cells around
// it:
//
//   a += m_s (x_s - x_t) (|x_s - x_t|^2 + eps^2)^(-3/2)
//
// unscaled by G; output ax, ay of shape [rows, res, K]. Columns past the
// grid edge are masked by index (rows come in padded). The d^2 > 0 mask is
// applied only when eps == 0, as barneshut._bucket_stencil does: an empty
// slot sits at (0, 0), so without it eps = 0 would give 0 * inf.
//
// What bounds it on the H100: arithmetic. A pair is ~8 f32 FP ops and one
// MUFU rsqrt (16/clk/SM, ~4.2e12/s on 132 SMs); the grid is read from device
// memory about once (12 of every 8 cells per side with the halo). The
// TPU kernel's slot-major [K, F] layout, 128-aligned stride and lead margin
// served its DMA alignment and are not carried over.
//
// Design: one thread per target (cell, slot). A block covers 8 x 8 target
// cells x K slots (1,024 threads at K = 16) and stages its cells plus the
// rr-cell halo in shared memory as float4 (x, y, m, 0): 12 x 12 cells x 16
// slots x 16 B = 36 KB at rr = 2. The 16 threads of a cell read the same
// source slot, so a warp (two cells) reads two broadcast float4 per pair.
// Slots fill from 0 in the force path, and a slot of mass 0 adds exactly 0,
// so each staged cell records 1 + its last slot of nonzero mass and the
// loop over a source cell stops there: the kernel evaluates the occupied
// source slots only, for every target slot (empty targets included, so the
// output matches the plain version everywhere). Sums run in the plain
// version's order -- offsets row-major, slots within an offset summed
// before the offset's total is added -- with no atomics, so the result is
// deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kCells = 8;    // target cells per block side
constexpr int kMaxCap = 16;  // slots per cell (threads: kCells^2 * cap)
constexpr int kMaxRR = 4;    // halo cells (acceptance radius <= 5)
constexpr int kMaxSide = kCells + 2 * kMaxRR;

template <bool MASK>
__global__ void __launch_bounds__(kCells * kCells * kMaxCap)
nearfield_kernel(const float* __restrict__ bx, const float* __restrict__ by,
                 const float* __restrict__ bm, float* __restrict__ ax,
                 float* __restrict__ ay, int rows, int res, int cap, int rr,
                 float eps_sq) {
  extern __shared__ float4 tile[];            // [side * side * cap]
  __shared__ int occupied[kMaxSide * kMaxSide];

  const int side = kCells + 2 * rr;
  const int row0 = blockIdx.y * kCells;       // window row of the staged top
  const int col0 = blockIdx.x * kCells - rr;  // grid column of the staged left
  const int rows_w = rows + 2 * rr;
  const int tid = threadIdx.x;

  const int n_stage = side * side * cap;
  for (int e = tid; e < n_stage; e += blockDim.x) {
    const int cell = e / cap;
    const int r = row0 + cell / side;
    const int c = col0 + cell % side;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_w && c >= 0 && c < res) {
      const size_t g = (static_cast<size_t>(r) * res + c) * cap + e % cap;
      q.x = bx[g];
      q.y = by[g];
      q.z = bm[g];
    }
    tile[e] = q;
  }
  __syncthreads();
  for (int cell = tid; cell < side * side; cell += blockDim.x) {
    int count = 0;
    for (int k = 0; k < cap; ++k)
      if (tile[cell * cap + k].z != 0.f) count = k + 1;
    occupied[cell] = count;
  }
  __syncthreads();

  const int slot = tid % cap;
  const int tcell = tid / cap;
  const int tr = tcell / kCells;
  const int tc = tcell % kCells;
  const float4 t = tile[((tr + rr) * side + tc + rr) * cap + slot];
  float accx = 0.f, accy = 0.f;
  for (int ox = 0; ox <= 2 * rr; ++ox) {
    for (int oy = 0; oy <= 2 * rr; ++oy) {
      const int sc = (tr + ox) * side + tc + oy;
      const float4* src = tile + sc * cap;
      const int count = occupied[sc];
      float px = 0.f, py = 0.f;
      for (int k = 0; k < count; ++k) {
        const float4 q = src[k];
        const float dx = q.x - t.x;
        const float dy = q.y - t.y;
        const float d_sq = dx * dx + dy * dy;
        const float inv = rsqrtf(d_sq + eps_sq);
        float w = q.z * (inv * inv * inv);
        if (MASK) w = d_sq > 0.f ? w : 0.f;  // eps = 0: rsqrt(0) = inf
        px += w * dx;
        py += w * dy;
      }
      accx += px;
      accy += py;
    }
  }
  const int i = row0 + tr;
  const int c = blockIdx.x * kCells + tc;
  if (i < rows && c < res) {
    const size_t o = (static_cast<size_t>(i) * res + c) * cap + slot;
    ax[o] = accx;
    ay[o] = accy;
  }
}

template <bool MASK>
int launch(const float* bx, const float* by, const float* bm, float* ax,
           float* ay, int rows, int res, int cap, int rr, float eps_sq,
           cudaStream_t stream) {
  const int side = kCells + 2 * rr;
  const int smem = side * side * cap * static_cast<int>(sizeof(float4));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nearfield_kernel<MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((res + kCells - 1) / kCells, (rows + kCells - 1) / kCells);
  nearfield_kernel<MASK><<<grid, kCells * kCells * cap, smem, stream>>>(
      bx, by, bm, ax, ay, rows, res, cap, rr, eps_sq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nb_bucket_stencil(const float* bx, const float* by,
                                 const float* bm, float* ax, float* ay,
                                 int rows, int res, int cap, int rr,
                                 float eps_sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || res <= 0 || cap <= 0 || cap > kMaxCap || rr < 0 ||
      rr > kMaxRR || rows > 65535 * kCells)
    return static_cast<int>(cudaErrorInvalidValue);
  if (eps_sq == 0.f)
    return launch<true>(bx, by, bm, ax, ay, rows, res, cap, rr, eps_sq, st);
  return launch<false>(bx, by, bm, ax, ay, rows, res, cap, rr, eps_sq, st);
}
