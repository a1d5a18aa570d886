// The quadtree's M2L: one level of the V-list pass as one kernel, f32.
//
// Replaces no TPU kernel: the JAX package runs this contraction as XLA's
// conv_general_dilated (nbodysim_tpu/physics/barneshut.py:_m2l_conv), and
// the port ran it as cuDNN's convolution with the layout work around it
// (physics/barneshut.py: _m2l_conv, the plain version, which the CPU still
// runs). For every target child cell x of a grid of side r (x = 2P + e:
// parent P, child parity e) and every V-list source s = 2(P + PO) + f (PO in
// [-(R-1), R-1]^2, f a child parity, o = s - x = 2PO + f - e with
// Chebyshev |o| >= R):
//
//   L_t(x) = scale_t * sum_o sum_c B_o[c, t] M_c(s)
//
// M: the source's 6 moments about its own cell centre in cell units (m,
// d_i / s_l, Q_ij / s_l^2; `_center_channels`'s arithmetic, op for op, so
// that the catastrophic cancellation of the synthesized raw moments at
// absolute coordinates rounds as in the plain version); L: the 9 local terms
// F [2], J [3], H [4]; scale_t = s_l^-(2, 3, 4) by term class; B_o: the
// scale-free translation block at offset o (eps_hat = eps^2 / s_l^2).
//
// What bounds it on the H100: f32 FMA. A source-target block has 42
// non-zero multiply-adds of its 6 x 9 (9 from the monopole, 9 from each
// dipole, 5 from each quadrupole, whose rows carry no H terms), a child has
// 3 (2R-1)^2 V-list sources, 75 at R = 3, so the 4096^2 level needs
// 4096^2 x 75 x 42 = 5.3e10 FMA, 1.58 ms at 67 TFLOP/s; its moments
// (6 channels) and terms (9) move 1.0 GB, 0.30 ms at 3.35 TB/s. No TF32 or
// tensor core: the port keeps the far field in full f32.
//
// Design (sized for the quadtree: 42 FMA a pair, 9 accumulators a target):
//  * B_o holds 54 numbers but only 14 distinct ones: the derivative tensors
//    of the softened 1/r at o, D1 [2], D2 [3], T [4] and U [5]. With the
//    moments loaded as (m, -d, h Q) (h = 1/2 on the diagonal, 1 off it)
//    every one of the 42 products is + (moment) x (a component of D1, D2, T
//    or V = -U). Each block builds that table, 16 floats an offset (2 of
//    them padding), (4R-1)^2 offsets (7.7 KB at R = 3), into shared memory
//    from `size` (a device scalar): no host-to-device copy, no host read,
//    no second launch.
//  * A block is 8 warps, two per target parity e, over a tile of 8 x 32
//    parent cells (x, y): a lane holds one parent column y and NT parents
//    along x (NT = 4 at R = 2, 3: 36 accumulators, two blocks an SM). The
//    block stages the children of the tile's parents and of a halo of R - 1
//    parents a side into shared memory, centred and sign-folded on load,
//    zero beyond the grid or the input window, one plane a source parity
//    laid out as the parents are (6 floats a cell, so a half-warp's 8-byte
//    loads hit 32 distinct banks).
//  * Per source parity f and parent offset POy, a lane loads the
//    NT + 2(R-1) sources its NT targets see along x into registers once;
//    then per kept POx it loads the offset's table row (four float4
//    broadcasts) and runs 42 FMA for each target, whose source is the
//    register row shifted by POx. The near pairs (Chebyshev |o| < R) and the
//    Q -> H block are never computed. Each accumulator sums its terms in one
//    fixed order (f, POy, POx, then the moments), with no atomics, so a
//    launch replays bit for bit.
//  * The epilogue scales each term by s_l^-(2, 3, 4) and writes the child
//    layout [9, B, rows, r] that the downward pass consumes, through shared
//    memory so that the stores run along y.
//
// Input: g, raw moments (m, m x, m y, m xx, m xy, m yy) of B grids at
// element strides (sb, sx, sy, sc); X rows in x, row 0 at global row x0;
// targets: the `rows` rows from row0 (both even) of the r x r grid.
// corner [B, 2], size [1] on the device.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;                // a warp: 32 parent columns (y)
constexpr int kCh = 6;                    // moment channels
constexpr int kTerms = 9;                 // local terms
constexpr int kW = 16;                    // table row: D1 2, D2 3, T 4, V 5
constexpr int kMaxSmem = 227 * 1024;      // a block's shared memory on Hopper

template <int R, int NT>
struct Tile {
  static constexpr int kWarps = 8;        // two per target parity
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int qh = R - 1;
  static constexpr int TX = 2 * NT;       // parents along x
  static constexpr int SX = TX + 2 * qh, SY = kLanes + 2 * qh;
  static constexpr int kPlane = SX * SY * kCh;    // floats, one source parity
  static constexpr int kOW = 4 * R - 1;           // offsets a side
  static constexpr int kTable = kOW * kOW * kW;
  // The block's terms, [9][2 TX][2 kLanes], staged over the planes so that
  // the stores run along y.
  static constexpr int kOut = kTerms * 2 * TX * 2 * kLanes;
  static constexpr int kStage = 4 * kPlane > kOut ? 4 * kPlane : kOut;
  static constexpr size_t kBytes = sizeof(float) * (kTable + kStage);
  static_assert(kBytes <= kMaxSmem, "the tile fits a block's shared memory");
};

// The table row of offset (rx, ry) in cell units: D1, D2, T, V = -U of the
// softened 1/r (the plain version's `_m2l_conv_weights` formulas, op for op
// with no contraction into FMA; the offsets are small integers, so most
// products are exact). Rows: D1 x y | D2 xx xy yy | T xxx xxy xyy yyy |
// V xxxx xxxy xxyy xyyy yyyy | 0 0.
__device__ void table_row(float* __restrict__ w, float rx, float ry,
                          float eps_hat) {
  auto m = [](float a, float b) { return __fmul_rn(a, b); };
  auto add = [](float a, float b) { return __fadd_rn(a, b); };
  auto sub = [](float a, float b) { return __fsub_rn(a, b); };
  const float x2 = m(rx, rx), y2 = m(ry, ry);
  const float inv = __frcp_rn(__fsqrt_rn(add(add(x2, y2), eps_hat)));
  const float inv3 = m(m(inv, inv), inv);
  const float inv5 = m(m(inv3, inv), inv);
  const float inv7 = m(m(inv5, inv), inv);
  const float inv9 = m(m(inv7, inv), inv);
  w[0] = m(inv3, rx);
  w[1] = m(inv3, ry);
  w[2] = sub(m(m(3.0f, x2), inv5), inv3);
  w[3] = m(m(m(3.0f, rx), ry), inv5);
  w[4] = sub(m(m(3.0f, y2), inv5), inv3);
  w[5] = sub(m(m(m(15.0f, x2), rx), inv7), m(m(9.0f, rx), inv5));
  w[6] = sub(m(m(m(15.0f, x2), ry), inv7), m(m(3.0f, ry), inv5));
  w[7] = sub(m(m(m(15.0f, rx), y2), inv7), m(m(3.0f, rx), inv5));
  w[8] = sub(m(m(m(15.0f, y2), ry), inv7), m(m(9.0f, ry), inv5));
  w[9] = -sub(add(m(m(m(-105.0f, x2), x2), inv9), m(m(90.0f, x2), inv7)),
              m(9.0f, inv5));
  w[10] = -add(m(m(m(m(-105.0f, x2), rx), ry), inv9),
               m(m(m(45.0f, rx), ry), inv7));
  w[11] = -sub(add(m(m(m(-105.0f, x2), y2), inv9),
                   m(m(15.0f, add(x2, y2)), inv7)), m(3.0f, inv5));
  w[12] = -add(m(m(m(m(-105.0f, y2), rx), ry), inv9),
               m(m(m(45.0f, rx), ry), inv7));
  w[13] = -sub(add(m(m(m(-105.0f, y2), y2), inv9), m(m(90.0f, y2), inv7)),
               m(9.0f, inv5));
  w[14] = 0.0f;
  w[15] = 0.0f;
}

// a += s . (w_0 .. w_5) in the moments' order; and its first three.
__device__ __forceinline__ void fma6(float& a, const float (&s)[kCh],
                                     float w0, float w1, float w2, float w3,
                                     float w4, float w5) {
  a = fmaf(s[0], w0, a);
  a = fmaf(s[1], w1, a);
  a = fmaf(s[2], w2, a);
  a = fmaf(s[3], w3, a);
  a = fmaf(s[4], w4, a);
  a = fmaf(s[5], w5, a);
}
__device__ __forceinline__ void fma3(float& a, const float (&s)[kCh],
                                     float w0, float w1, float w2) {
  a = fmaf(s[0], w0, a);
  a = fmaf(s[1], w1, a);
  a = fmaf(s[2], w2, a);
}

// 42 FMA: the target's 9 terms (Fx Fy | Jxx Jxy Jyy | Hxxx Hxxy Hxyy Hyyy)
// from one source's folded moments s = (m, -dx, -dy, Qxx/2, Qxy, Qyy/2) and
// the offset's table row w: F_i = m D1_i - d_c D2_ic + hQ_ab T_iab,
// J_ij = m D2_ij - d_c T_ijc + hQ_ab V_ijab, H_ijk = m T_ijk - d_c V_ijkc.
__device__ __forceinline__ void contract(float (&a)[kTerms],
                                         const float (&w)[kW],
                                         const float (&s)[kCh]) {
  fma6(a[0], s, w[0], w[2], w[3], w[5], w[6], w[7]);
  fma6(a[1], s, w[1], w[3], w[4], w[6], w[7], w[8]);
  fma6(a[2], s, w[2], w[5], w[6], w[9], w[10], w[11]);
  fma6(a[3], s, w[3], w[6], w[7], w[10], w[11], w[12]);
  fma6(a[4], s, w[4], w[7], w[8], w[11], w[12], w[13]);
  fma3(a[5], s, w[5], w[9], w[10]);
  fma3(a[6], s, w[6], w[10], w[11]);
  fma3(a[7], s, w[7], w[11], w[12]);
  fma3(a[8], s, w[8], w[12], w[13]);
}

template <int R, int NT>
__global__ void __launch_bounds__(Tile<R, NT>::kThreads, 2)
m2l2_kernel(const float* __restrict__ g, long long sb, long long sx,
            long long sy, long long sc, int X, int x0, int r, int row0,
            int rows, const float* __restrict__ corner,
            const float* __restrict__ size, float eps_sq,
            float* __restrict__ out, int batch, int ntx, int nty) {
  using Tl = Tile<R, NT>;
  constexpr int qh = Tl::qh, SX = Tl::SX, SY = Tl::SY, TX = Tl::TX;
  constexpr int OW = Tl::kOW, OR = 2 * R - 1, NS = NT + 2 * qh;
  extern __shared__ __align__(16) float smem[];
  float* wtab = smem;
  float* plane = smem + Tl::kTable;

  int bid = blockIdx.x;
  const int ty = bid % nty;
  bid /= nty;
  const int tx = bid % ntx;
  const int b = bid / ntx;
  const int p0x = tx * TX, p0y = ty * kLanes;   // the tile's first parent
  const int px0 = row0 / 2;          // global parent row of target row 0

  // s_l = size / r as torch divides a tensor by a Python number on the
  // card (times the float reciprocal); 1 / s_l and eps_sq / s_l^2 as it
  // evaluates a number over a tensor (the reciprocal, times the number).
  const float s_l = __fmul_rn(size[0], __frcp_rn(static_cast<float>(r)));
  const float inv_s = __frcp_rn(s_l);
  const float inv2 = __fmul_rn(inv_s, inv_s);
  const float half_s = __fmul_rn(0.5f, s_l);
  const float eps_hat = __fmul_rn(__frcp_rn(__fmul_rn(s_l, s_l)), eps_sq);
  const float c0x = corner[2 * b], c0y = corner[2 * b + 1];
  const float* gb = g + static_cast<long long>(b) * sb;

  for (int idx = threadIdx.x; idx < OW * OW; idx += Tl::kThreads)
    table_row(wtab + idx * kW, static_cast<float>(idx / OW - OR),
              static_cast<float>(idx % OW - OR), eps_hat);
  // Stage every source parity, child cells in the grid's own order (y
  // fastest), so a warp reads whole lines.
#pragma unroll 4
  for (int idx = threadIdx.x; idx < 4 * SX * SY; idx += Tl::kThreads) {
    const int cy = idx % (2 * SY), cx = idx / (2 * SY);
    const int i = cx >> 1, j = cy >> 1, f = 2 * (cx & 1) + (cy & 1);
    const int gx = 2 * (px0 + p0x - qh + i) + (cx & 1);
    const int gy = 2 * (p0y - qh + j) + (cy & 1);
    const int row = gx - x0;
    float v[kCh] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (gx >= 0 && gx < r && gy >= 0 && gy < r && row >= 0 && row < X) {
      const float* p = gb + row * sx + gy * sy;
      float raw[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) raw[c] = __ldg(p + c * sc);
      // `_center_channels`, op for op (no contraction into FMA).
      const float cxc = __fadd_rn(
          __fadd_rn(c0x, __fmul_rn(static_cast<float>(gx), s_l)), half_s);
      const float cyc = __fadd_rn(
          __fadd_rn(c0y, __fmul_rn(static_cast<float>(gy), s_l)), half_s);
      const float m = raw[0], mx = raw[1], my = raw[2];
      const float mcx = __fmul_rn(m, cxc), mcy = __fmul_rn(m, cyc);
      v[0] = m;
      v[1] = -__fmul_rn(__fsub_rn(mx, mcx), inv_s);
      v[2] = -__fmul_rn(__fsub_rn(my, mcy), inv_s);
      v[3] = 0.5f * __fmul_rn(
          __fadd_rn(__fsub_rn(raw[3], __fmul_rn(__fmul_rn(2.0f, cxc), mx)),
                    __fmul_rn(mcx, cxc)), inv2);
      v[4] = __fmul_rn(
          __fadd_rn(__fsub_rn(__fsub_rn(raw[4], __fmul_rn(cxc, my)),
                              __fmul_rn(cyc, mx)),
                    __fmul_rn(mcx, cyc)), inv2);
      v[5] = 0.5f * __fmul_rn(
          __fadd_rn(__fsub_rn(raw[5], __fmul_rn(__fmul_rn(2.0f, cyc), my)),
                    __fmul_rn(mcy, cyc)), inv2);
    }
    float2* d = reinterpret_cast<float2*>(plane + f * Tl::kPlane +
                                          (i * SY + j) * kCh);
#pragma unroll
    for (int c = 0; c < kCh / 2; ++c)
      d[c] = make_float2(v[2 * c], v[2 * c + 1]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, ly = threadIdx.x & 31;
  const int e = warp & 3, wx = warp >> 2;
  const int ex = e >> 1, ey = e & 1;
  float acc[NT][kTerms];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int k = 0; k < kTerms; ++k) acc[t][k] = 0.0f;

#pragma unroll 1
  for (int f = 0; f < 4; ++f) {
    const int fx = f >> 1, fy = f & 1;
    // Row 0 of the lane's sources: its first target's row less qh.
    const float* lane_src = plane + f * Tl::kPlane +
                            (wx * NT * SY + ly + qh) * kCh;
#pragma unroll 1
    for (int poy = -qh; poy <= qh; ++poy) {
      const int oy = 2 * poy + fy - ey;
      const bool near_row = (oy < 0 ? -oy : oy) < R;
      float s[NS][kCh];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2* p2 = reinterpret_cast<const float2*>(
            lane_src + (j * SY + poy) * kCh);
#pragma unroll
        for (int c = 0; c < kCh / 2; ++c) {
          const float2 v2 = p2[c];
          s[j][2 * c] = v2.x;
          s[j][2 * c + 1] = v2.y;
        }
      }
#pragma unroll
      for (int k = 0; k <= 2 * qh; ++k) {
        const int ox = 2 * (k - qh) + fx - ex;
        if (near_row && (ox < 0 ? -ox : ox) < R) continue;   // near: not M2L
        const float4* wp = reinterpret_cast<const float4*>(
            wtab + ((ox + OR) * OW + oy + OR) * kW);
        float w[kW];
#pragma unroll
        for (int c = 0; c < kW / 4; ++c) {
          const float4 q4 = wp[c];
          w[4 * c] = q4.x;
          w[4 * c + 1] = q4.y;
          w[4 * c + 2] = q4.z;
          w[4 * c + 3] = q4.w;
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) contract(acc[t], w, s[t + k]);
      }
    }
  }

  // F, J, H scale as s_l^-(2, 3, 4). The terms go through shared memory
  // ([9][2 TX][2 kLanes] children of the tile) so that the stores run
  // along y.
  const float sc2 = inv2, sc3 = __fmul_rn(inv2, inv_s),
              sc4 = __fmul_rn(inv2, inv2);
  constexpr int CX = 2 * TX, CY = 2 * kLanes;
  __syncthreads();
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      const float scale = k < 2 ? sc2 : (k < 5 ? sc3 : sc4);
      plane[(k * CX + 2 * (wx * NT + t) + ex) * CY + 2 * ly + ey] =
          __fmul_rn(acc[t][k], scale);
    }
  __syncthreads();
  const long long plane_terms = static_cast<long long>(batch) * rows * r;
  for (int idx = threadIdx.x; idx < Tl::kOut; idx += Tl::kThreads) {
    const int cy = idx % CY, cx = (idx / CY) % CX, k = idx / (CY * CX);
    const int ox = 2 * p0x + cx, oy = 2 * p0y + cy;
    if (ox >= rows || oy >= r) continue;
    out[k * plane_terms + (static_cast<long long>(b) * rows + ox) * r + oy] =
        plane[idx];
  }
}

template <int R, int NT>
int launch(const float* g, long long sb, long long sx, long long sy,
           long long sc, int batch, int X, int x0, int r, int row0,
           int rows, const float* corner, const float* size, float eps_sq,
           float* out, cudaStream_t st) {
  using Tl = Tile<R, NT>;
  const long long ntx = (rows / 2 + Tl::TX - 1) / Tl::TX,
                  nty = (r / 2 + kLanes - 1) / kLanes;
  const long long blocks = batch * ntx * nty;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = m2l2_kernel<R, NT>;
  if (Tl::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tl::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), Tl::kThreads, Tl::kBytes, st>>>(
      g, sb, sx, sy, sc, X, x0, r, row0, rows, corner, size, eps_sq, out,
      batch, static_cast<int>(ntx), static_cast<int>(nty));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One M2L level (see the file's note); out: [9, batch, rows, r].
extern "C" int nb_m2l2(const float* g, long long sb, long long sx,
                       long long sy, long long sc, int batch, int X, int x0,
                       int r, int row0, int rows, const float* corner,
                       const float* size, float eps_sq, int radius,
                       float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || X <= 0 || r < 2 || r % 2 || rows <= 0 || rows % 2 ||
      row0 < 0 || row0 % 2 || row0 + rows > r)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto args = [&](auto fn) {
    return fn(g, sb, sx, sy, sc, batch, X, x0, r, row0, rows, corner, size,
              eps_sq, out, st);
  };
  // 4 target parents a thread where the register row of sources is short
  // (R = 2, 3), 2 from R = 4.
  switch (radius) {
    case 2: return args(launch<2, 4>);
    case 3: return args(launch<3, 4>);
    case 4: return args(launch<4, 2>);
    case 5: return args(launch<5, 2>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
