// The octree's M2L: one level of the V-list pass as one kernel, f32.
//
// Replaces no TPU kernel: the JAX package runs this contraction as XLA's
// conv_general_dilated (nbodysim_tpu/physics/barneshut3d.py:_m2l_conv3), and
// the port ran it as cuDNN's convolution with the layout work around it
// (kernels/m2l3.py: _m2l_conv3, the plain version, which the CPU still runs).
// For every target child cell x of a grid of side r (x = 2P + e: parent P,
// child parity e) and every V-list source s = 2(P + PO) + f (PO in
// [-(R-1), R-1]^3, f a child parity, o = s - x = 2PO + f - e with
// Chebyshev |o| >= R):
//
//   L_t(x) = scale_t * sum_o sum_c B_o[c, t] M_c(s)
//
// M: the source's 10 moments about its own cell centre in cell units
// (m, d_i / s_l, Q_ij / s_l^2; `_center_channels3`'s arithmetic, op for op,
// so that the catastrophic cancellation of raw moments at absolute
// coordinates rounds as in the plain version); L: the 19 local terms F [3],
// J [6], H [10]; scale_t = s_l^-(2, 3, 4) by term class; B_o: the
// scale-free translation block at offset o (eps_hat = eps^2 / s_l^2).
//
// What bounds it on the H100: f32 FMA. A source-target block has 130
// non-zero multiply-adds of its 10 x 19 (the quadrupole rows carry no H
// terms), a child has 189 V-list sources at R = 2, so the 256^3 level needs
// 256^3 x 189 x 130 = 4.1e11 FMA, 12.3 ms at 67 TFLOP/s; its moments
// (10 channels) and terms (19) move 1.95 GB, 0.58 ms at 3.35 TB/s. No TF32 or
// tensor core: the port keeps the far field in full f32.
//
// Design:
//  * B_o holds 190 numbers but only 34 distinct ones: the derivative
//    tensors of the softened 1/r at o, D1 [3], D2 [6], T [10] and U [15].
//    With the moments loaded as (m, -d, h Q) (h = 1/2 on the diagonal, 1 off
//    it) every one of the 130 products is + (moment) x (a component of
//    D1, D2, T or V = -U). So the table is 36 floats an offset, (4R-1)^3
//    offsets (49 KB at R = 2, L1-resident): a prologue kernel builds it on
//    the device from `size` (a device scalar) for each launch, and the main
//    kernel reads it with warp-uniform loads. No host-to-device copy and no
//    host read.
//  * A block is 8 warps, one per target parity e, over a tile of
//    T x 4 x 8 parent cells (x, y, z); a lane holds the T parents along x
//    of one (y, z), T x 19 accumulators in registers (T = 8 at R = 2: 252
//    registers, one block an SM). The block stages the children of the
//    tile's parents and of a halo of R - 1 parents a side into shared
//    memory, all 8 source parities at once where they fit (215 KB at R = 2;
//    one at a time from R = 4), centred and sign-folded on load, zero beyond
//    the grid or the input window (so the callers' zero padding, stacks and
//    space-to-depth copies are gone). Each parity's plane is laid out as the
//    parents are, so the lanes' 8-byte loads of one source offset are
//    bank-conflict free (rows padded to 16 mod 32 floats).
//  * Per kept (PO, f) the warp loads the offset's 34 weights once and runs
//    130 FMA for each of its T targets: the inner loop is 1,109
//    instructions, 1,040 of them FFMA, at R = 2. The near pairs (Chebyshev
//    |o| < R: the whole centre tap and 19 more at R = 2) and the Q -> H
//    block are never computed. Each accumulator sums its terms in one fixed
//    order (f, then PO in row-major order), with no atomics, so a launch
//    replays bit for bit.
//  * The epilogue scales each term by s_l^-(2, 3, 4) and writes the child
//    layout [19, B, rows, r, r] that the downward pass consumes, through
//    shared memory so that the stores run along z.
//
// Input: g, raw moments (m, m x, m y, m z, m xx, m xy, m xz, m yy, m yz,
// m zz) of B grids at element strides (sb, sx, sy, sz, sc); X slabs in x,
// slab 0 at global x index x0; targets: the `rows` x-slabs from row0 (both
// even) of the r^3 grid. corner [B, 3], size [1] on the device.

#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int kWarps = 8;                 // one warp per target parity
constexpr int kThreads = 32 * kWarps;
constexpr int kTY = 4;                    // a warp's lanes: 4 parents in y
constexpr int kTZ = 8;                    //   x 8 parents in z
constexpr int kCh = 10;                   // moment channels
constexpr int kTerms = 19;                // local terms
constexpr int kW = 36;                    // table row: D1 3, D2 6, T 10, V 15
constexpr int kD2 = 3, kT3 = 9, kV4 = 19;  // their offsets in the row

// Index of a symmetric tensor component with nx x-indices and ny
// y-indices among n, in the order xx..x, xx..y, ..., zz..z (the plain
// version's term order: xx, xy, xz, yy, yz, zz; xxx, xxy, ..., zzz).
__host__ __device__ constexpr int sym_index(int nx, int ny, int n) {
  int idx = n - nx - ny;
  for (int k = nx + 1; k <= n; ++k) idx += n - k + 1;
  return idx;
}
__host__ __device__ constexpr int sym2(int i, int j) {
  return sym_index((i == 0) + (j == 0), (i == 1) + (j == 1), 2);
}
__host__ __device__ constexpr int sym3(int i, int j, int k) {
  return sym_index((i == 0) + (j == 0) + (k == 0),
                   (i == 1) + (j == 1) + (k == 1), 3);
}
__host__ __device__ constexpr int sym4(int i, int j, int k, int l) {
  return sym_index((i == 0) + (j == 0) + (k == 0) + (l == 0),
                   (i == 1) + (j == 1) + (k == 1) + (l == 1), 4);
}
// The axes of pair p (xx, xy, xz, yy, yz, zz) and of triple h (xxx ...).
__host__ __device__ constexpr int pair_a(int p) {
  return p < 3 ? 0 : (p < 5 ? 1 : 2);
}
__host__ __device__ constexpr int pair_b(int p) {
  return p < 3 ? p : (p < 5 ? p - 2 : 2);
}
// Triples: xxx xxy xxz | xyy xyz xzz | yyy yyz yzz | zzz; after the
// first axis, h = 3..8 repeat the pairs yy, yz, zz.
__host__ __device__ constexpr int tri_a(int h) {
  return h < 6 ? 0 : (h < 9 ? 1 : 2);
}
__host__ __device__ constexpr int tri_b(int h) {
  return h < 3 ? 0 : (h == 9 ? 2 : pair_a(3 + (h - 3) % 3));
}
__host__ __device__ constexpr int tri_c(int h) {
  return h < 3 ? h : (h == 9 ? 2 : pair_b(3 + (h - 3) % 3));
}

// Floats in one (x, y) row of the staged plane: SZ cells of 10, padded to
// 16 mod 32 so that a half-warp's 8-byte loads (8 z-lanes x 2 y-lanes) hit
// 32 distinct banks.
__host__ __device__ constexpr int row_stride(int sz) {
  int rs = sz * kCh;
  while (rs % 32 != 16) rs += 2;
  return rs;
}

constexpr int kMaxSmem = 227 * 1024;     // a block's shared memory on Hopper

template <int R, int T>
struct Tile {
  static constexpr int qh = R - 1;
  static constexpr int SX = T + 2 * qh, SY = kTY + 2 * qh, SZ = kTZ + 2 * qh;
  static constexpr int RS = row_stride(SZ);
  static constexpr int kPlane = SX * SY * RS;     // floats, one source parity
  // Source parities staged at once: all 8 where they fit (one barrier a
  // block, and no warp waits for another's share of a parity), else one.
  static constexpr int kNP =
      8 * kPlane * static_cast<int>(sizeof(float)) <= kMaxSmem ? 8 : 1;
  static constexpr size_t kBytes = sizeof(float) * kPlane * kNP;
  // The block's terms, [19][2T][2 kTY][2 kTZ], staged in shared memory so
  // that the stores run along z.
  static constexpr int kOut = kTerms * 2 * T * 2 * kTY * 2 * kTZ;
  static_assert(kOut <= kPlane * kNP, "the terms fit the staged planes");
};

// The contraction's 130 FMA, in order: F_i (m, d, Q), J_ij (m, d, Q), H_ijk
// (m, d); step k adds moment `mom` times table entry `w` to term `acc`.
struct Fma {
  int acc, mom, w;
};
__host__ __device__ constexpr Fma fma_step(int k) {
  int n = 0;
  for (int i = 0; i < 3; ++i) {                       // F_i
    if (n++ == k) return {i, 0, i};
    for (int c = 0; c < 3; ++c)
      if (n++ == k) return {i, 1 + c, kD2 + sym2(i, c)};
    for (int q = 0; q < 6; ++q)
      if (n++ == k) return {i, 4 + q, kT3 + sym3(i, pair_a(q), pair_b(q))};
  }
  for (int p = 0; p < 6; ++p) {                       // J_ij
    const int i = pair_a(p), j = pair_b(p);
    if (n++ == k) return {3 + p, 0, kD2 + p};
    for (int c = 0; c < 3; ++c)
      if (n++ == k) return {3 + p, 1 + c, kT3 + sym3(i, j, c)};
    for (int q = 0; q < 6; ++q)
      if (n++ == k)
        return {3 + p, 4 + q, kV4 + sym4(i, j, pair_a(q), pair_b(q))};
  }
  for (int h = 0; h < 10; ++h) {                      // H_ijk
    const int i = tri_a(h), j = tri_b(h), l = tri_c(h);
    if (n++ == k) return {9 + h, 0, kT3 + h};
    for (int c = 0; c < 3; ++c)
      if (n++ == k) return {9 + h, 1 + c, kV4 + sym4(i, j, l, c)};
  }
  return {-1, -1, -1};
}
constexpr int kFma = 130;
static_assert(fma_step(kFma - 1).acc == kTerms - 1 &&
              fma_step(kFma).acc == -1, "130 FMA a source-target pair");

// One step with its indices fixed at compile time (template arguments), so
// that the weights, moments and accumulators stay in registers.
template <int K>
__device__ __forceinline__ void fma_at(float (&a)[kTerms],
                                       const float (&w)[kW],
                                       const float (&s)[kCh]) {
  constexpr Fma f = fma_step(K);
  a[f.acc] = fmaf(s[f.mom], w[f.w], a[f.acc]);
}

template <int... K>
__device__ __forceinline__ void contract_steps(
    float (&a)[kTerms], const float (&w)[kW], const float (&s)[kCh],
    std::integer_sequence<int, K...>) {
  (fma_at<K>(a, w, s), ...);
}

// 130 FMA: the target's 19 terms from one source's 10 folded moments
// (m, -d, h Q) and the offset's table row w.
__device__ __forceinline__ void contract(float (&a)[kTerms],
                                         const float (&w)[kW],
                                         const float (&s)[kCh]) {
  contract_steps(a, w, s, std::make_integer_sequence<int, kFma>{});
}

// The table: row o = ((ox + 2R-1) (4R-1) + oy + 2R-1) (4R-1) + oz + 2R-1
// of kW floats, D1, D2, T, V = -U at offset o in cell units (the plain
// version's `_m2l_conv_weights3` formulas, op for op; the offsets are small
// integers, so most products are exact).
__global__ void m2l3_table_kernel(float* __restrict__ wtab,
                                  const float* __restrict__ size, int r,
                                  float eps_sq, int radius) {
  const int ow = 4 * radius - 1, orr = 2 * radius - 1;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ow * ow * ow) return;
  const float rx = static_cast<float>(idx / (ow * ow) - orr);
  const float ry = static_cast<float>((idx / ow) % ow - orr);
  const float rz = static_cast<float>(idx % ow - orr);
  const float s_l = __fdiv_rn(size[0], static_cast<float>(r));
  // eps_sq / (s_l s_l) as torch evaluates a float over a tensor: the
  // reciprocal, times the float.
  const float eps_hat =
      __fmul_rn(__frcp_rn(__fmul_rn(s_l, s_l)), eps_sq);
  const float q = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(rx, rx),
                                                __fmul_rn(ry, ry)),
                                      __fmul_rn(rz, rz)), eps_hat);
  const float inv = __frcp_rn(__fsqrt_rn(q));
  const float inv3 = __fmul_rn(__fmul_rn(inv, inv), inv);
  const float inv5 = __fmul_rn(__fmul_rn(inv3, inv), inv);
  const float inv7 = __fmul_rn(__fmul_rn(inv5, inv), inv);
  const float inv9 = __fmul_rn(__fmul_rn(inv7, inv), inv);
  const float r3[3] = {rx, ry, rz};
  float* w = wtab + static_cast<size_t>(idx) * kW;

  auto m = [](float a, float b) { return __fmul_rn(a, b); };
  auto sub = [](float a, float b) { return __fsub_rn(a, b); };
  auto add = [](float a, float b) { return __fadd_rn(a, b); };

  for (int i = 0; i < 3; ++i) w[i] = m(inv3, r3[i]);
  for (int p = 0; p < 6; ++p) {
    const int i = pair_a(p), j = pair_b(p);
    const float v = m(m(m(3.0f, r3[i]), r3[j]), inv5);
    w[kD2 + p] = i == j ? sub(v, inv3) : v;
  }
  // T_ijk = 15 r_i r_j r_k inv7 - 3 (d_ij r_k + d_ik r_j + d_jk r_i) inv5.
  for (int h = 0; h < 10; ++h) {
    const int i = tri_a(h), j = tri_b(h), k = tri_c(h);
    const float lead = m(m(m(m(15.0f, r3[i]), r3[j]), r3[k]), inv7);
    float v = lead;
    if (i == j && j == k) {
      v = sub(lead, m(m(9.0f, r3[i]), inv5));
    } else if (i == j) {
      v = sub(lead, m(m(3.0f, r3[k]), inv5));
    } else if (j == k) {
      v = sub(lead, m(m(3.0f, r3[i]), inv5));
    }
    w[kT3 + h] = v;
  }
  // U (the plain version's u_aaaa, u_aaab, u_aabb, u_aabc), stored negated.
  const float r2[3] = {m(rx, rx), m(ry, ry), m(rz, rz)};
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j)
      for (int k = j; k < 3; ++k)
        for (int l = k; l < 3; ++l) {
          int n[3] = {0, 0, 0};
          ++n[i]; ++n[j]; ++n[k]; ++n[l];
          float u;
          int a = 0;
          while (n[a] < 2 && a < 2) ++a;   // an axis with n >= 2 if any
          if (n[a] == 4) {
            u = sub(add(m(m(m(-105.0f, r2[a]), r2[a]), inv9),
                        m(m(90.0f, r2[a]), inv7)), m(9.0f, inv5));
          } else if (n[a] == 3) {
            int b = 0;
            while (n[b] != 1) ++b;
            u = add(m(m(m(m(-105.0f, r2[a]), r3[a]), r3[b]), inv9),
                    m(m(m(45.0f, r3[a]), r3[b]), inv7));
          } else if (n[a] == 2) {
            int b = 0;
            while (b == a || n[b] == 0) ++b;
            if (n[b] == 2) {
              u = sub(add(m(m(m(-105.0f, r2[a]), r2[b]), inv9),
                          m(m(15.0f, add(r2[a], r2[b])), inv7)),
                      m(3.0f, inv5));
            } else {
              int c = b + 1;
              while (c == a || n[c] == 0) ++c;
              u = add(m(m(m(m(-105.0f, r2[a]), r3[b]), r3[c]), inv9),
                      m(m(m(15.0f, r3[b]), r3[c]), inv7));
            }
          } else {
            u = 0.0f;   // rank 4 in 3 axes always repeats one
          }
          w[kV4 + sym4(i, j, k, l)] = -u;
        }
  w[34] = 0.0f;
  w[35] = 0.0f;
}

template <int R, int T>
__global__ void __launch_bounds__(kThreads)
m2l3_kernel(const float* __restrict__ g, long long sb, long long sx,
            long long sy, long long sz, long long sc, int X, int x0, int r,
            int row0, int rows, const float* __restrict__ corner,
            const float* __restrict__ size,
            const float* __restrict__ wtab, float* __restrict__ out,
            int batch, int ntx, int nty, int ntz) {
  using Tl = Tile<R, T>;
  constexpr int qh = Tl::qh, SX = Tl::SX, SY = Tl::SY, SZ = Tl::SZ;
  constexpr int RS = Tl::RS, NP = Tl::kNP;
  constexpr int OW = 4 * R - 1, OR = 2 * R - 1;
  extern __shared__ __align__(16) float plane[];

  int bid = blockIdx.x;
  const int tz = bid % ntz;
  bid /= ntz;
  const int ty = bid % nty;
  bid /= nty;
  const int tx = bid % ntx;
  const int b = bid / ntx;
  const int p0x = tx * T, p0y = ty * kTY, p0z = tz * kTZ;   // parents
  const int px0 = row0 / 2;          // global parent x of target slab 0

  const float s_l = __fdiv_rn(size[0], static_cast<float>(r));
  const float inv_s = __frcp_rn(s_l);
  const float inv2 = __fmul_rn(inv_s, inv_s);
  const float half_s = __fmul_rn(0.5f, s_l);
  const float c0x = corner[3 * b], c0y = corner[3 * b + 1],
              c0z = corner[3 * b + 2];
  const float* gb = g + static_cast<long long>(b) * sb;

  const int e = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ex = e >> 2, ey = (e >> 1) & 1, ez = e & 1;
  const int ly = lane >> 3, lz = lane & 7;

  float acc[T][kTerms];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int k = 0; k < kTerms; ++k) acc[t][k] = 0.0f;

#pragma unroll 1
  for (int f0 = 0; f0 < 8; f0 += NP) {
    __syncthreads();                  // the previous planes are consumed
    // Stage parities f0 .. f0 + NP - 1: with all 8, child cells in the
    // grid's own order (z fastest), so a warp reads whole lines.
#pragma unroll 4
    for (int idx = threadIdx.x; idx < NP * SX * SY * SZ; idx += kThreads) {
      int i, j, k, f;
      if (NP == 8) {
        const int cz = idx % (2 * SZ), cy = (idx / (2 * SZ)) % (2 * SY),
                  cx = idx / (4 * SZ * SY);
        i = cx >> 1;
        j = cy >> 1;
        k = cz >> 1;
        f = 4 * (cx & 1) + 2 * (cy & 1) + (cz & 1);
      } else {
        k = idx % SZ;
        j = (idx / SZ) % SY;
        i = idx / (SZ * SY);
        f = f0;
      }
      const int gx = 2 * (px0 + p0x - qh + i) + (f >> 2);
      const int gy = 2 * (p0y - qh + j) + ((f >> 1) & 1);
      const int gz = 2 * (p0z - qh + k) + (f & 1);
      const int slab = gx - x0;
      float v[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) v[c] = 0.0f;
      if (gx >= 0 && gx < r && gy >= 0 && gy < r && gz >= 0 && gz < r &&
          slab >= 0 && slab < X) {
        const float* p = gb + slab * sx + gy * sy + gz * sz;
        float raw[kCh];
#pragma unroll
        for (int c = 0; c < kCh; ++c) raw[c] = __ldg(p + c * sc);
        // `_center_channels3`, op for op (no contraction into FMA).
        const float cx = __fadd_rn(
            __fadd_rn(c0x, __fmul_rn(static_cast<float>(gx), s_l)), half_s);
        const float cy = __fadd_rn(
            __fadd_rn(c0y, __fmul_rn(static_cast<float>(gy), s_l)), half_s);
        const float cz = __fadd_rn(
            __fadd_rn(c0z, __fmul_rn(static_cast<float>(gz), s_l)), half_s);
        const float m = raw[0], mx = raw[1], my = raw[2], mz = raw[3];
        const float mcx = __fmul_rn(m, cx), mcy = __fmul_rn(m, cy);
        auto diag = [&](float raw2, float c, float s1, float mc) {
          return __fmul_rn(
              __fadd_rn(__fsub_rn(raw2, __fmul_rn(__fmul_rn(2.0f, c), s1)),
                        __fmul_rn(mc, c)), inv2);
        };
        auto off = [&](float raw2, float ca, float sb_, float cb, float sa,
                       float mca) {
          return __fmul_rn(
              __fadd_rn(__fsub_rn(__fsub_rn(raw2, __fmul_rn(ca, sb_)),
                                  __fmul_rn(cb, sa)),
                        __fmul_rn(mca, cb)), inv2);
        };
        v[0] = m;
        v[1] = -__fmul_rn(__fsub_rn(mx, mcx), inv_s);
        v[2] = -__fmul_rn(__fsub_rn(my, mcy), inv_s);
        v[3] = -__fmul_rn(__fsub_rn(mz, __fmul_rn(m, cz)), inv_s);
        v[4] = 0.5f * diag(raw[4], cx, mx, mcx);
        v[5] = off(raw[5], cx, my, cy, mx, mcx);
        v[6] = off(raw[6], cx, mz, cz, mx, mcx);
        v[7] = 0.5f * diag(raw[7], cy, my, mcy);
        v[8] = off(raw[8], cy, mz, cz, my, mcy);
        v[9] = 0.5f * diag(raw[9], cz, mz, __fmul_rn(m, cz));
      }
      float2* d = reinterpret_cast<float2*>(
          plane + (f - f0) * Tl::kPlane + (i * SY + j) * RS + k * kCh);
#pragma unroll
      for (int c = 0; c < kCh / 2; ++c)
        d[c] = make_float2(v[2 * c], v[2 * c + 1]);
    }
    __syncthreads();

#pragma unroll 1
    for (int f = f0; f < f0 + NP; ++f) {
      const int fx = f >> 2, fy = (f >> 1) & 1, fz = f & 1;
      const float* lane_src = plane + (f - f0) * Tl::kPlane +
                              (qh * SY + ly + qh) * RS + (lz + qh) * kCh;
#pragma unroll 1
      for (int pox = -qh; pox <= qh; ++pox) {
        const int ox = 2 * pox + fx - ex;
#pragma unroll 1
        for (int poy = -qh; poy <= qh; ++poy) {
          const int oy = 2 * poy + fy - ey;
#pragma unroll 1
          for (int poz = -qh; poz <= qh; ++poz) {
            const int oz = 2 * poz + fz - ez;
            const int ax = ox < 0 ? -ox : ox, ay = oy < 0 ? -oy : oy,
                      az = oz < 0 ? -oz : oz;
            if (ax < R && ay < R && az < R) continue;   // near: not M2L
            const float4* wp = reinterpret_cast<const float4*>(
                wtab + (((ox + OR) * OW + oy + OR) * OW + oz + OR) * kW);
            float w[kW];
#pragma unroll
            for (int c = 0; c < kW / 4; ++c) {
              const float4 q4 = __ldg(wp + c);
              w[4 * c] = q4.x;
              w[4 * c + 1] = q4.y;
              w[4 * c + 2] = q4.z;
              w[4 * c + 3] = q4.w;
            }
            const float* src = lane_src + (pox * SY + poy) * RS + poz * kCh;
#pragma unroll
            for (int t = 0; t < T; ++t) {
              const float2* s2 =
                  reinterpret_cast<const float2*>(src + t * SY * RS);
              float s[kCh];
#pragma unroll
              for (int c = 0; c < kCh / 2; ++c) {
                const float2 v2 = s2[c];
                s[2 * c] = v2.x;
                s[2 * c + 1] = v2.y;
              }
              contract(acc[t], w, s);
            }
          }
        }
      }
    }
  }

  // F, J, H scale as s_l^-(2, 3, 4). The terms go through shared memory
  // ([19][2T][8][16] children of the tile) so that the stores run along z.
  const float sc2 = inv2, sc3 = __fmul_rn(inv2, inv_s),
              sc4 = __fmul_rn(inv2, inv2);
  constexpr int CX = 2 * T, CY = 2 * kTY, CZ = 2 * kTZ;
  __syncthreads();
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      const float scale = k < 3 ? sc2 : (k < 9 ? sc3 : sc4);
      plane[((k * CX + 2 * t + ex) * CY + 2 * ly + ey) * CZ + 2 * lz + ez] =
          __fmul_rn(acc[t][k], scale);
    }
  __syncthreads();
  const long long plane_terms =
      static_cast<long long>(batch) * rows * r * r;
  for (int idx = threadIdx.x; idx < Tl::kOut; idx += kThreads) {
    const int cz = idx % CZ, cy = (idx / CZ) % CY, cx = (idx / (CZ * CY)) % CX;
    const int k = idx / (CZ * CY * CX);
    const int ox_ = 2 * p0x + cx, oy_ = 2 * p0y + cy, oz_ = 2 * p0z + cz;
    if (ox_ >= rows || oy_ >= r || oz_ >= r) continue;
    out[k * plane_terms +
        ((static_cast<long long>(b) * rows + ox_) * r + oy_) * r + oz_] =
        plane[idx];
  }
}

template <int R, int T>
int launch(const float* g, long long sb, long long sx, long long sy,
           long long sz, long long sc, int batch, int X, int x0, int r,
           int row0, int rows, const float* corner, const float* size,
           float eps_sq, float* wtab, float* out, cudaStream_t st) {
  using Tl = Tile<R, T>;
  const int ow = 4 * R - 1;
  m2l3_table_kernel<<<(ow * ow * ow + 127) / 128, 128, 0, st>>>(
      wtab, size, r, eps_sq, R);
  const int h = r / 2, hb = rows / 2;
  const long long ntx = (hb + T - 1) / T, nty = (h + kTY - 1) / kTY,
                  ntz = (h + kTZ - 1) / kTZ;
  const long long blocks = batch * ntx * nty * ntz;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = m2l3_kernel<R, T>;
  if (Tl::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tl::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, Tl::kBytes, st>>>(
      g, sb, sx, sy, sz, sc, X, x0, r, row0, rows, corner, size, wtab, out,
      batch, static_cast<int>(ntx), static_cast<int>(nty),
      static_cast<int>(ntz));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of the table scratch `wtab` a launch at this radius needs.
extern "C" int nb_m2l3_table_floats(int radius) {
  const int ow = 4 * radius - 1;
  return ow * ow * ow * kW;
}

// One M2L level (see the file's note). wtab: nb_m2l3_table_floats(radius)
// floats of scratch; out: [19, batch, rows, r, r].
extern "C" int nb_m2l3(const float* g, long long sb, long long sx,
                       long long sy, long long sz, long long sc, int batch,
                       int X, int x0, int r, int row0, int rows,
                       const float* corner, const float* size, float eps_sq,
                       int radius, float* wtab, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || X <= 0 || r < 2 || r % 2 || rows <= 0 || rows % 2 ||
      row0 < 0 || row0 % 2 || row0 + rows > r)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto args = [&](auto fn) {
    return fn(g, sb, sx, sy, sz, sc, batch, X, x0, r, row0, rows, corner,
              size, eps_sq, wtab, out, st);
  };
  // 8 target parents a thread at R = 2 (256^3 level: 18.3 ms, against 20.4
  // and 20.6 at 2 and 4); 2 from R = 3, whose halos need the room.
  switch (radius) {
    case 2: return args(launch<2, 8>);
    case 3: return args(launch<3, 2>);
    case 4: return args(launch<4, 2>);
    case 5: return args(launch<5, 2>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
