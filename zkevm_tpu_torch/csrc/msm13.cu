// Kernel L: the sort and prefix-scan MSM over the lazy-13 field.
//
// Replaces the TPU kernels of zkevm_tpu/ec/msm13.py: madd_l, add_l and
// double_l (point formulas on lazy-13 coordinates with fused signed-scaled
// reductions, identity as a flag), _window_sums (per-lane scan of sorted
// leaves, two-level blocked exclusive scan of the lane totals, prefix sums
// at the 2^c - 1 digit boundaries, log-depth boundary tree, (B-1) * Total -
// sum PS) and _horner_full. The field arithmetic is kernel J's
// (lazy13.cuh): every reduction runs on the int8 tensor cores. The sort of
// (digit, index) per window stays torch.sort, as in kernel C.
//
// Bound on the H100: the per-lane scan's mixed additions (7 products, 4
// squarings, 12 reduction terms each) over N points per window dominate;
// their 32-bit multiplies bound it (16.7 T/s), the u8 MACs on the tensor
// cores are ~20x below that, and bytes (the gather of 168-byte leaves) far
// below. Design: one thread per (window, lane) walks its S sorted leaves
// with the accumulator in registers, reading leaves that the gather laid
// out step-major so a warp's reads are contiguous. The order of additions
// is the reference's, but the boundary tree doubles where its inputs are
// equal (the reference raises its doubling flag there); every word equals
// the plain version's (ec/msm13.py). Unlike the reference (2.1 GB of
// prefix values per group of 8 windows at N = 2^20),
// a lane stores its prefix value only where a digit's run ends, indexed by
// digit: the only values the boundaries read. Each later stage is one
// thread per point, and the Horner one warp; every other addition's flag
// of equal inputs is OR-ed into one word for the caller's fallback.
//
// Point arrays are (3, 21, count) u32: coordinate k, limb l of point i at
// [(k * 21 + l) * count + i], with a (count) byte of identity flags.

#include "lazy13.cuh"

using namespace l13;

namespace {

constexpr int THREADS = 128;

struct Pt {
  uint32_t x[L], y[L], z[L];
  bool inf;
};

struct Ctx {
  Field F;
  Mats M;
};

#define L13_WARP                                                  \
  __shared__ uint32_t smem_[THREADS / 32 * SLOT_WORDS];           \
  const Warp w{smem_ + (threadIdx.x >> 5) * SLOT_WORDS, static_cast<int>(threadIdx.x & 31)}

__device__ __forceinline__ void set_identity(Pt& p) {
  set_small(p.x, 1u);
  set_small(p.y, 1u);
  set_small(p.z, 0u);
  p.inf = true;
}

__device__ __forceinline__ void load_xyz(Pt& p, const uint32_t* __restrict__ c, i64 i, i64 n) {
  load13(p.x, c, i, n);
  load13(p.y, c + L * n, i, n);
  load13(p.z, c + 2 * L * n, i, n);
}

__device__ __forceinline__ void load_pt(Pt& p, const uint32_t* __restrict__ c, const uint8_t* __restrict__ inf, i64 i,
                                        i64 n) {
  load_xyz(p, c, i, n);
  p.inf = inf[i] != 0;
}

__device__ __forceinline__ void store_xyz(uint32_t* __restrict__ c, const Pt& p, i64 i, i64 n) {
  store13(c, p.x, i, n);
  store13(c + L * n, p.y, i, n);
  store13(c + 2 * L * n, p.z, i, n);
}

__device__ __forceinline__ void store_pt(uint32_t* __restrict__ c, uint8_t* __restrict__ inf, const Pt& p, i64 i,
                                         i64 n) {
  store_xyz(c, p, i, n);
  inf[i] = p.inf ? 1 : 0;
}

// madd-2007-bl: p += (qx, qy), the leaf never the identity. Products whose
// columns the reference reuses (z1^2, h^2, h^3, x1 h^2) are recomputed from
// their 21-limb factors: the same integers, fewer live registers.
__device__ __noinline__ void madd_l(const Ctx& C, const Warp& w, Pt& p, const uint32_t* qx, const uint32_t* qy,
                                    bool& same) {
  const Field& F = C.F;
  const Mats& M = C.M;
  uint32_t z1z1[L], u2[L], s2[L], h[L], hh[L], j[L], v[L], rh[L], x3[L], y3[L], z3[L], tmp[L];
  Acc A;
  sqr13(F, M, w, p.z, z1z1);
  mul13(F, M, w, qx, z1z1, u2);
  mul13(F, M, w, qy, p.z, tmp);
  mul13(F, M, w, tmp, z1z1, s2);
  sub13(F, u2, p.x, h);
  sqr13(F, M, w, h, hh);
  acc_zero(A);
  term_prod(A, w, h, hh, M.s[S4]);
  acc_finish(F, A, w, j);
  acc_zero(A);
  term_prod(A, w, p.x, hh, M.s[S4]);
  acc_finish(F, A, w, v);
  sub13(F, s2, p.y, rh);
  acc_zero(A);
  term_sqr(A, w, rh, M.s[S4]);
  term_prod(A, w, h, hh, M.s[SM4]);
  term_prod(A, w, p.x, hh, M.s[SM8]);
  acc_finish(F, A, w, x3);
  sub13(F, v, x3, tmp);  // v - x3
  acc_zero(A);
  term_prod(A, w, rh, tmp, M.s[S2]);
  term_prod(A, w, p.y, j, M.s[SM2]);
  acc_finish(F, A, w, y3);
  add13(F, p.z, h, tmp);  // z1 + h
  acc_zero(A);
  term_sqr(A, w, tmp, M.s[S1]);
  term_sqr(A, w, p.z, M.s[SM1]);
  term_sqr(A, w, h, M.s[SM1]);
  acc_finish(F, A, w, z3);
  const bool hz = is_zero13(F, h), rz = is_zero13(F, rh);
  same = hz && rz && !p.inf;
  const bool opposite = hz && !rz && !p.inf;
  if (p.inf) {
    copy13(p.x, qx);
    copy13(p.y, qy);
    set_small(p.z, 1u);
  } else {
    copy13(p.x, x3);
    copy13(p.y, y3);
    copy13(p.z, z3);
  }
  p.inf = opposite;
}

// add-2007-bl, complete by flag selects: p = p + q.
__device__ __noinline__ void add_l(const Ctx& C, const Warp& w, Pt& p, const Pt& q, bool& same) {
  const Field& F = C.F;
  const Mats& M = C.M;
  uint32_t z1z1[L], z2z2[L], u1[L], u2[L], s1[L], s2[L], h[L], rh[L], hh[L], j[L], v[L], x3[L], y3[L], z3[L],
      tmp[L];
  Acc A;
  sqr13(F, M, w, p.z, z1z1);
  sqr13(F, M, w, q.z, z2z2);
  mul13(F, M, w, p.x, z2z2, u1);
  mul13(F, M, w, q.x, z1z1, u2);
  mul13(F, M, w, p.y, q.z, tmp);
  mul13(F, M, w, tmp, z2z2, s1);
  mul13(F, M, w, q.y, p.z, tmp);
  mul13(F, M, w, tmp, z1z1, s2);
  sub13(F, u2, u1, h);
  sub13(F, s2, s1, rh);
  sqr13(F, M, w, h, hh);
  acc_zero(A);
  term_prod(A, w, h, hh, M.s[S4]);
  acc_finish(F, A, w, j);
  acc_zero(A);
  term_prod(A, w, u1, hh, M.s[S4]);
  acc_finish(F, A, w, v);
  acc_zero(A);
  term_sqr(A, w, rh, M.s[S4]);
  term_prod(A, w, h, hh, M.s[SM4]);
  term_prod(A, w, u1, hh, M.s[SM8]);
  acc_finish(F, A, w, x3);
  sub13(F, v, x3, tmp);
  acc_zero(A);
  term_prod(A, w, rh, tmp, M.s[S2]);
  term_prod(A, w, s1, j, M.s[SM2]);
  acc_finish(F, A, w, y3);
  add13(F, p.z, q.z, tmp);
  acc_zero(A);
  term_sqr(A, w, tmp, M.s[S1]);
  term_sqr(A, w, p.z, M.s[SM1]);
  term_sqr(A, w, q.z, M.s[SM1]);
  acc_finish(F, A, w, tmp);  // (z1 + z2)^2 - z1^2 - z2^2
  mul13(F, M, w, tmp, h, z3);
  const bool hz = is_zero13(F, h), rz = is_zero13(F, rh);
  const bool both = !p.inf && !q.inf;
  same = hz && rz && both;
  const bool opposite = hz && !rz && both;
  if (p.inf) {  // the reference's select_l(p.inf, q, out), then select_l(q.inf & ~p.inf, p, out)
    copy13(p.x, q.x);
    copy13(p.y, q.y);
    copy13(p.z, q.z);
    p.inf = q.inf;
  } else if (!q.inf) {
    copy13(p.x, x3);
    copy13(p.y, y3);
    copy13(p.z, z3);
    p.inf = opposite;
  }
}

// dbl-2009-l: p = 2p (the identity flag is kept).
__device__ __noinline__ void double_l(const Ctx& C, const Warp& w, Pt& p) {
  const Field& F = C.F;
  const Mats& M = C.M;
  uint32_t b[L], c[L], d[L], e[L], x3[L], tmp[L];
  Acc A;
  sqr13(F, M, w, p.y, b);
  add13(F, p.x, b, tmp);  // x + b
  acc_zero(A);
  term_sqr(A, w, tmp, M.s[S2]);
  term_sqr(A, w, p.x, M.s[SM2]);
  term_sqr(A, w, b, M.s[SM2]);  // c = b^2: its columns are sqr_T(b)
  acc_finish(F, A, w, d);
  acc_zero(A);
  term_sqr(A, w, p.x, M.s[S3]);
  acc_finish(F, A, w, e);
  sqr13(F, M, w, e, x3);
  add13(F, d, d, tmp);
  sub13(F, x3, tmp, x3);
  sub13(F, d, x3, tmp);  // d - x3
  acc_zero(A);
  term_prod(A, w, e, tmp, M.s[S1]);
  term_sqr(A, w, b, M.s[SM8]);
  acc_finish(F, A, w, c);  // y3
  acc_zero(A);
  term_prod(A, w, p.y, p.z, M.s[S2]);
  acc_finish(F, A, w, p.z);
  copy13(p.x, x3);
  copy13(p.y, c);
}

__device__ __forceinline__ i64 thread_index() { return static_cast<i64>(blockIdx.x) * THREADS + threadIdx.x; }

// --- elementwise point operations (comparisons with the plain version) ----

__global__ void __launch_bounds__(THREADS) k_point_op(const __grid_constant__ Ctx C, int op, uint32_t* __restrict__ out,
                                                      uint8_t* __restrict__ out_inf, const uint32_t* __restrict__ p,
                                                      const uint8_t* __restrict__ p_inf, const uint32_t* __restrict__ q,
                                                      const uint8_t* __restrict__ q_inf, int* flag, i64 n) {
  L13_WARP;
  const i64 i = thread_index();
  const i64 ic = i < n ? i : n - 1;
  Pt a;
  load_pt(a, p, p_inf, ic, n);
  bool same = false;
  if (op == 0) {
    Pt b;
    load_pt(b, q, q_inf, ic, n);
    add_l(C, w, a, b, same);
  } else if (op == 1) {
    uint32_t qx[L], qy[L];
    load13(qx, q, ic, n);
    load13(qy, q + L * n, ic, n);
    madd_l(C, w, a, qx, qy, same);
  } else {
    double_l(C, w, a);
  }
  if (i < n) {
    store_pt(out, out_inf, a, i, n);
    if (same) atomicOr(flag, 1);
  }
}

// --- the MSM ----------------------------------------------------------------

// (W, n) c-bit digits of (n, 8) standard-form words: bits [w c, w c + c)
__global__ void k_digits(int* __restrict__ digits, const uint32_t* __restrict__ scalars, i64 n, int c, int W) {
  const i64 i = thread_index();
  if (i >= n * W) return;
  const int win = static_cast<int>(i / n);
  const i64 e = i % n;
  const int start = win * c, word = start / 32, off = start % 32;
  uint32_t v = scalars[e * 8 + word] >> off;
  if (off + c > 32 && word + 1 < 8) v |= scalars[e * 8 + word + 1] << (32 - off);
  digits[i] = static_cast<int>(v & ((1u << c) - 1u));
}

// Sorted leaves of windows g0..g0+G, step-major: leaves[s][xy][limb][g Lw +
// lane] is sorted position lane S + s of window g0 + g. tags[s][g Lw + lane]
// is the digit when that position ends its digit's run (and the digit is
// below B - 1, so some boundary reads it), else -1.
__global__ void k_gather(uint32_t* __restrict__ leaves, int* __restrict__ tags, const uint32_t* __restrict__ ax,
                         const uint32_t* __restrict__ ay, const int* __restrict__ sd, const int* __restrict__ perm,
                         int g0, int G, i64 n, i64 Lw, i64 S, int B) {
  const i64 i = thread_index();
  const i64 gl = G * Lw;
  if (i >= S * gl) return;
  const i64 s = i / gl, r = i % gl, g = r / Lw, lane = r % Lw;
  const i64 pos = lane * S + s;
  const i64 row = (g0 + g) * n;
  const i64 idx = perm[row + pos];
  const int d = sd[row + pos];
  const bool run_end = pos == n - 1 || sd[row + pos + 1] != d;
  tags[s * gl + r] = (run_end && d < B - 1) ? d : -1;
  uint32_t* out = leaves + s * 2 * L * gl;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    out[l * gl + r] = ax[l * n + idx];
    out[(L + l) * gl + r] = ay[l * n + idx];
  }
}

// One thread per (window, lane): S mixed additions from the identity.
__global__ void __launch_bounds__(THREADS) k_scan(const __grid_constant__ Ctx C, uint32_t* __restrict__ within, uint32_t* __restrict__ totals,
                                                  const uint32_t* __restrict__ leaves, const int* __restrict__ tags,
                                                  int G, i64 Lw, i64 S, int B, int* flag) {
  L13_WARP;
  const i64 gl = G * Lw;
  const i64 i = thread_index();
  const bool valid = i < gl;
  const i64 ic = valid ? i : gl - 1;
  const i64 g = ic / Lw;
  Pt acc;
  set_identity(acc);
  bool any = false;
  for (i64 s = 0; s < S; ++s) {
    const uint32_t* leaf = leaves + s * 2 * L * gl;
    uint32_t qx[L], qy[L];
    load13(qx, leaf, ic, gl);
    load13(qy, leaf + L * gl, ic, gl);
    bool same;
    madd_l(C, w, acc, qx, qy, same);
    any = any || same;
    const int tag = tags[s * gl + ic];
    if (valid && tag >= 0) store_xyz(within, acc, g * B + tag, static_cast<i64>(G) * B);
  }
  if (valid) {
    store_xyz(totals, acc, i, gl);
    if (any) atomicOr(flag, 1);
  }
}

// Exclusive scan over blen of each of nb blocks of points (their identity
// flags dropped, as the reference's): offsets (nb * blen) and totals (nb).
__global__ void __launch_bounds__(THREADS) k_exscan(const __grid_constant__ Ctx C, uint32_t* __restrict__ offs, uint8_t* __restrict__ offs_inf,
                                                    uint32_t* __restrict__ tots, uint8_t* __restrict__ tots_inf,
                                                    const uint32_t* __restrict__ in, i64 nb, i64 blen, int* flag) {
  L13_WARP;
  const i64 i = thread_index();
  const bool valid = i < nb;
  const i64 ic = valid ? i : nb - 1;
  const i64 count = nb * blen;
  Pt acc;
  set_identity(acc);
  bool any = false;
  for (i64 b = 0; b < blen; ++b) {
    if (valid) store_pt(offs, offs_inf, acc, ic * blen + b, count);
    Pt q;
    load_xyz(q, in, ic * blen + b, count);
    q.inf = false;
    bool same;
    add_l(C, w, acc, q, same);
    any = any || same;
  }
  if (valid) {
    store_pt(tots, tots_inf, acc, i, nb);
    if (any) atomicOr(flag, 1);
  }
}

// off[g Lw + a Bz + b] = block offset [g A + a] + within-block offset
__global__ void __launch_bounds__(THREADS) k_offsets(const __grid_constant__ Ctx C, uint32_t* __restrict__ off, uint8_t* __restrict__ off_inf,
                                                     const uint32_t* __restrict__ bo, const uint8_t* __restrict__ bo_inf,
                                                     const uint32_t* __restrict__ wo, const uint8_t* __restrict__ wo_inf,
                                                     int G, i64 A, i64 Bz, int* flag) {
  L13_WARP;
  const i64 count = G * A * Bz;
  const i64 i = thread_index();
  const i64 ic = i < count ? i : count - 1;
  Pt p, q;
  load_pt(p, bo, bo_inf, ic / Bz, G * A);
  load_pt(q, wo, wo_inf, ic, count);
  bool same;
  add_l(C, w, p, q, same);
  if (i < count) {
    store_pt(off, off_inf, p, i, count);
    if (same) atomicOr(flag, 1);
  }
}

// First index of a sorted row with digit >= t.
__device__ __forceinline__ i64 lower_bound(const int* __restrict__ row, i64 n, int t) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (row[mid] < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// bacc[g m + k], k < B - 1: the prefix sum of the points with digit <= k of
// window g0 + g, lane offset + within-lane prefix; the identity where no
// digit is <= k; k >= B - 1: the tree's padding (0, 0, 0, identity).
__global__ void __launch_bounds__(THREADS) k_boundaries(const __grid_constant__ Ctx C, uint32_t* __restrict__ bacc,
                                                        uint8_t* __restrict__ bacc_inf, const uint32_t* __restrict__ within,
                                                        const uint32_t* __restrict__ off,
                                                        const uint8_t* __restrict__ off_inf, const int* __restrict__ sd,
                                                        int g0, int G, i64 n, i64 Lw, i64 S, int B, i64 m, int* flag) {
  L13_WARP;
  const i64 count = G * m;
  const i64 i = thread_index();
  const i64 ic = i < count ? i : count - 1;
  const i64 g = ic / m, k = ic % m;
  const int t = static_cast<int>(k < B - 1 ? k + 1 : B - 1);
  const int* row = sd + (g0 + g) * n;
  const i64 pos = lower_bound(row, n, t) - 1;
  const bool is_neg = pos < 0;
  const i64 posc = is_neg ? 0 : pos;
  Pt p, q;
  load_pt(p, off, off_inf, g * Lw + posc / S, G * Lw);
  if (is_neg) {
    set_small(q.x, 0u);
    set_small(q.y, 0u);
    set_small(q.z, 0u);
  } else {
    load_xyz(q, within, g * B + row[posc], static_cast<i64>(G) * B);
  }
  q.inf = false;
  bool same;
  add_l(C, w, p, q, same);
  if (is_neg) set_identity(p);
  if (k >= B - 1) {
    set_small(p.x, 0u);
    set_small(p.y, 0u);
    set_small(p.z, 0u);
    p.inf = true;
  }
  if (i < count) {
    store_pt(bacc, bacc_inf, p, i, count);
    if (same && !is_neg && k < B - 1) atomicOr(flag, 1);
  }
}

// One level of the boundary tree: bacc[g m + i] += bacc[g m + i + half], i < half.
// Boundaries that no digit separates hold equal prefix sums (every one past
// a window's largest digit holds its total), so where the inputs are equal
// the sum is the doubling of the first: the whole warp doubles when any
// lane needs it (the reduction is warp-collective), and no flag is raised.
__global__ void __launch_bounds__(THREADS) k_tree(const __grid_constant__ Ctx C, uint32_t* __restrict__ bacc, uint8_t* __restrict__ bacc_inf,
                                                  int G, i64 m, i64 half) {
  L13_WARP;
  const i64 count = G * half;
  const i64 i = thread_index();
  const i64 ic = i < count ? i : count - 1;
  const i64 g = ic / half, k = ic % half;
  Pt p, q;
  load_pt(p, bacc, bacc_inf, g * m + k, G * m);
  load_pt(q, bacc, bacc_inf, g * m + k + half, G * m);
  bool same;
  add_l(C, w, p, q, same);
  if (__any_sync(0xffffffffu, same)) {
    load_pt(q, bacc, bacc_inf, g * m + k, G * m);  // the first input again
    double_l(C, w, q);
    if (same) p = q;
  }
  if (i < count) store_pt(bacc, bacc_inf, p, g * m + k, G * m);  // in place: only this thread reads index k < half
}

// G_w = (B - 1) * Total - sum PS for each window g0 + g.
__global__ void __launch_bounds__(THREADS) k_window(const __grid_constant__ Ctx C, uint32_t* __restrict__ gw, uint8_t* __restrict__ gw_inf,
                                                    const uint32_t* __restrict__ bacc, const uint8_t* __restrict__ bacc_inf,
                                                    const uint32_t* __restrict__ grand,
                                                    const uint8_t* __restrict__ grand_inf, int g0, int G, int W, i64 m,
                                                    int c, int* flag) {
  L13_WARP;
  const i64 i = thread_index();
  const i64 ic = i < G ? i : G - 1;
  Pt acc, cur, s;
  set_identity(acc);
  load_pt(cur, grand, grand_inf, ic, G);
  bool any = false, same;
  for (int k = 0; k < c; ++k) {
    add_l(C, w, acc, cur, same);
    any = any || same;
    double_l(C, w, cur);
  }
  load_pt(s, bacc, bacc_inf, ic * m, G * m);
  uint32_t zero[L];
  set_small(zero, 0u);
  sub13(C.F, zero, s.y, s.y);
  add_l(C, w, acc, s, same);
  any = any || same;
  if (i < G) {
    store_pt(gw, gw_inf, acc, g0 + i, W);
    if (any) atomicOr(flag, 1);
  }
}

// Horner over the W window sums, last window first: one warp, lane 0 stores.
__global__ void __launch_bounds__(32) k_horner(const __grid_constant__ Ctx C, uint32_t* __restrict__ out, uint8_t* __restrict__ out_inf,
                                               const uint32_t* __restrict__ gw, const uint8_t* __restrict__ gw_inf, int W,
                                               int c, int* flag) {
  __shared__ uint32_t smem_[SLOT_WORDS];
  const Warp w{smem_, static_cast<int>(threadIdx.x & 31)};
  Pt acc;
  set_identity(acc);
  bool any = false, same;
  for (int win = W - 1; win >= 0; --win) {
    for (int k = 0; k < c; ++k) double_l(C, w, acc);
    Pt q;
    load_pt(q, gw, gw_inf, win, W);
    add_l(C, w, acc, q, same);
    any = any || same;
  }
  if (threadIdx.x == 0) {
    store_pt(out, out_inf, acc, 0, 1);
    if (any) atomicOr(flag, 1);
  }
}

Ctx make_ctx(const Field* field, const unsigned long long* mats) {
  Ctx C;
  C.F = *field;
  for (int s = 0; s < NSCALES; ++s) C.M.s[s] = reinterpret_cast<const uint4*>(mats[s]);
  return C;
}

int blocks(i64 n) { return zk_blocks(n, THREADS); }

}  // namespace

typedef const Field* FieldP;
typedef const unsigned long long* MatsP;

ZK_EXPORT int zk_msm13_point_op(FieldP f, MatsP m, i64 op, uint32_t* out, uint8_t* out_inf, const uint32_t* p,
                                const uint8_t* p_inf, const uint32_t* q, const uint8_t* q_inf, int* flag, i64 n,
                                cudaStream_t stream) {
  k_point_op<<<blocks(n), THREADS, 0, stream>>>(make_ctx(f, m), static_cast<int>(op), out, out_inf, p, p_inf, q, q_inf,
                                                flag, n);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_msm13_digits(FieldP, MatsP, int* digits, const uint32_t* scalars, i64 n, i64 c, i64 W,
                              cudaStream_t stream) {
  k_digits<<<blocks(n * W), THREADS, 0, stream>>>(digits, scalars, n, static_cast<int>(c), static_cast<int>(W));
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_msm13_gather(FieldP, MatsP, uint32_t* leaves, int* tags, const uint32_t* ax, const uint32_t* ay,
                              const int* sd, const int* perm, i64 g0, i64 G, i64 n, i64 Lw, i64 S, i64 B,
                              cudaStream_t stream) {
  k_gather<<<blocks(S * G * Lw), THREADS, 0, stream>>>(leaves, tags, ax, ay, sd, perm, static_cast<int>(g0),
                                                       static_cast<int>(G), n, Lw, S, static_cast<int>(B));
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_msm13_scan(FieldP f, MatsP m, uint32_t* within, uint32_t* totals, const uint32_t* leaves,
                            const int* tags, i64 G, i64 Lw, i64 S, i64 B, int* flag, cudaStream_t stream) {
  k_scan<<<blocks(G * Lw), THREADS, 0, stream>>>(make_ctx(f, m), within, totals, leaves, tags, static_cast<int>(G), Lw, S,
                                                 static_cast<int>(B), flag);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_msm13_exscan(FieldP f, MatsP m, uint32_t* offs, uint8_t* offs_inf, uint32_t* tots, uint8_t* tots_inf,
                              const uint32_t* in, i64 nb, i64 blen, int* flag, cudaStream_t stream) {
  k_exscan<<<blocks(nb), THREADS, 0, stream>>>(make_ctx(f, m), offs, offs_inf, tots, tots_inf, in, nb, blen, flag);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_msm13_offsets(FieldP f, MatsP m, uint32_t* off, uint8_t* off_inf, const uint32_t* bo,
                               const uint8_t* bo_inf, const uint32_t* wo, const uint8_t* wo_inf, i64 G, i64 A, i64 Bz,
                               int* flag, cudaStream_t stream) {
  k_offsets<<<blocks(G * A * Bz), THREADS, 0, stream>>>(make_ctx(f, m), off, off_inf, bo, bo_inf, wo, wo_inf,
                                                        static_cast<int>(G), A, Bz, flag);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_msm13_boundaries(FieldP f, MatsP m, uint32_t* bacc, uint8_t* bacc_inf, const uint32_t* within,
                                  const uint32_t* off, const uint8_t* off_inf, const int* sd, i64 g0, i64 G, i64 n,
                                  i64 Lw, i64 S, i64 B, i64 mm, int* flag, cudaStream_t stream) {
  k_boundaries<<<blocks(G * mm), THREADS, 0, stream>>>(make_ctx(f, m), bacc, bacc_inf, within, off, off_inf, sd,
                                                       static_cast<int>(g0), static_cast<int>(G), n, Lw, S,
                                                       static_cast<int>(B), mm, flag);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_msm13_tree(FieldP f, MatsP m, uint32_t* bacc, uint8_t* bacc_inf, i64 G, i64 mm, i64 half,
                            cudaStream_t stream) {
  k_tree<<<blocks(G * half), THREADS, 0, stream>>>(make_ctx(f, m), bacc, bacc_inf, static_cast<int>(G), mm, half);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_msm13_window(FieldP f, MatsP m, uint32_t* gw, uint8_t* gw_inf, const uint32_t* bacc,
                              const uint8_t* bacc_inf, const uint32_t* grand, const uint8_t* grand_inf, i64 g0, i64 G,
                              i64 W, i64 mm, i64 c, int* flag, cudaStream_t stream) {
  k_window<<<blocks(G), THREADS, 0, stream>>>(make_ctx(f, m), gw, gw_inf, bacc, bacc_inf, grand, grand_inf,
                                              static_cast<int>(g0), static_cast<int>(G), static_cast<int>(W), mm,
                                              static_cast<int>(c), flag);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_msm13_horner(FieldP f, MatsP m, uint32_t* out, uint8_t* out_inf, const uint32_t* gw,
                              const uint8_t* gw_inf, i64 W, i64 c, int* flag, cudaStream_t stream) {
  k_horner<<<1, 32, 0, stream>>>(make_ctx(f, m), out, out_inf, gw, gw_inf, static_cast<int>(W), static_cast<int>(c),
                                 flag);
  return static_cast<int>(cudaGetLastError());
}
