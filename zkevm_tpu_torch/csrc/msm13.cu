// Kernel L: the sort and prefix-scan MSM over the lazy-13 field.
//
// Replaces the TPU kernels of zkevm_tpu/ec/msm13.py: madd_l, add_l and
// double_l (point formulas on lazy-13 coordinates with fused signed-scaled
// reductions, identity as a flag), _window_sums (per-lane scan of sorted
// leaves, two-level blocked exclusive scan of the lane totals, prefix sums
// at the 2^c - 1 digit boundaries, log-depth boundary tree, (B-1) * Total -
// sum PS) and _horner_full. The field arithmetic is kernel J's (lazy13.cuh:
// 13-bit limbs, 441 u32 limb products a product, the reduction mod p on the
// int8 tensor cores); the sort of (digit, index) per window stays
// torch.sort, as in kernel C.
//
// Bound on the H100: the per-lane scan's mixed additions (4011 32-bit
// multiplies and 15 reduction terms each) over N points per window; their
// multiplies bound it (16.7 T/s), the u8 MACs on the tensor cores are ~20x
// below that, bytes (a 96-byte base read per addition) far below. The
// other stages are n-independent: ~2^c additions per window in the
// boundaries and the tree, and chains of dependent additions (the lane
// offsets' two blocked scans, the window sums, the Horner) that one warp
// runs alone.
//
// Design. Every window runs in the same launch of each stage (28 launches
// an MSM at c = 16: digits, scan, four exscans and three offsets for the
// lane offsets, boundaries, one per tree level, window, Horner). The scan reads each leaf in place, through
// the sorted permutation, from the bases' point-major copy (n, 24) u32 that
// Msm13 keeps (x and y each 11 words of two 16-bit-packed limbs, 16-byte
// aligned), with the next leaf prefetched to L2; its run-end tags come from
// the sorted digits themselves. Its accumulator stays in registers, packed
// (33 words), for the whole walk: every point formula is inlined and keeps
// its waiting values packed, unpacking a 21-limb element only for its
// products. The eight scaled reduction matrices (73.7 KB, in L's own K
// order) are staged in dynamic shared memory once per block; a product's
// 41 columns go to the warp's slot as they are summed, four at a time
// (16-byte stores at a rotation that keeps both the stores and the 16-byte
// B-fragment loads free of bank conflicts). Every other point is a 40-word
// record (x, y, z packed at words 0, 12, 24; the identity flag at 36),
// read where a formula needs it. Stages with many points loop over them in
// one wave of blocks; a warp skips the addition when none of its lanes
// needs it (identity inputs, boundaries with no smaller digit, the tree's
// padding) and the doubling when none meets equal inputs.
//
// Words: the scan, the boundaries, the tree, the window sums and the
// Horner keep the reference's order of additions; the lane offsets do not
// (the wrapper runs k_exscan over groups of at most 8 lane totals that
// divide a window's lanes, level by level, and k_offsets back down: 35
// dependent additions at 4096 lanes, where the reference's two blocked
// scans chain 129). So L's words differ from the reference's: they are
// the plain version's (ec/msm13.py) with lane_radix = 8. Its affine points
// and flags agree with the reference's only where no repeated base meets
// itself: with a repeated base, one association can raise the flag where
// the other does not.
// The boundary tree doubles where its inputs are equal (the reference
// raises its doubling flag there); every other addition's flag of equal
// inputs is OR-ed into one word for the caller's fallback.

#include "lazy13.cuh"

using namespace l13;

namespace {

constexpr int THREADS = 128;
constexpr int SCAN_BLOCKS = 2;    // k_scan's resident blocks an SM: 255 registers (at 3 or 4 it spills and runs slower)
constexpr int SWL = 48;           // words per element of a product slot
constexpr int SLOTW = 32 * SWL;   // words per warp
constexpr int MATQ = 3 * 6 * 32;  // uint4 of one reduction matrix
constexpr int SMEM_BYTES = NSCALES * MATQ * 16 + THREADS / 32 * SLOTW * 4;
constexpr int PW = 11;                                    // words of a packed element
constexpr int RW = 40;                                    // words of a point record
constexpr int RY = 12, RZ = 24, RINF = 36;
constexpr int BW = 24;                                    // words of a base (x at 0, y at 12)
constexpr unsigned FULL = 0xffffffffu;

struct Ctx {
  Field F;
  const uint4* mats;  // NSCALES x MATQ, L's fragment order (ec/msm13.py fragment_matrix_l)
};

// A warp's reduction context: the staged matrices and its product slot.
struct Red {
  const uint4* mats;
  uint32_t* slot;
  int lane;
};

struct PP {  // a point with packed coordinates
  uint32_t x[PW], y[PW], z[PW];
  bool inf;
};

__device__ __forceinline__ Red setup(const Ctx& C) {
  extern __shared__ uint4 smem_[];
  for (int i = threadIdx.x; i < NSCALES * MATQ; i += blockDim.x) smem_[i] = C.mats[i];
  __syncthreads();
  return Red{smem_, reinterpret_cast<uint32_t*>(smem_ + NSCALES * MATQ) + (threadIdx.x >> 5) * SLOTW,
             static_cast<int>(threadIdx.x & 31)};
}

// --- packed elements and records -------------------------------------------

__device__ __forceinline__ void pack(uint32_t w[PW], const uint32_t a[L]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) w[i] = a[2 * i] | (a[2 * i + 1] << 16);
  w[10] = a[20];
}

__device__ __forceinline__ void unpack(uint32_t a[L], const uint32_t w[PW]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    a[2 * i] = w[i] & 0xFFFFu;
    a[2 * i + 1] = w[i] >> 16;
  }
  a[20] = w[10];
}

__device__ __forceinline__ void ld_pk(uint32_t w[PW], const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 a = q[0], b = q[1], c = q[2];
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  w[8] = c.x, w[9] = c.y, w[10] = c.z;
}

__device__ __forceinline__ void ldg_pk(uint32_t w[PW], const uint32_t* __restrict__ p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  w[8] = c.x, w[9] = c.y, w[10] = c.z;
}

__device__ __forceinline__ void st_pk(uint32_t* p, const uint32_t w[PW]) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(w[0], w[1], w[2], w[3]);
  q[1] = make_uint4(w[4], w[5], w[6], w[7]);
  q[2] = make_uint4(w[8], w[9], w[10], 0u);
}

__device__ __forceinline__ void ld_el(uint32_t a[L], const uint32_t* p) {
  uint32_t w[PW];
  ld_pk(w, p);
  unpack(a, w);
}

__device__ __forceinline__ bool rec_inf(const uint32_t* rec) { return rec[RINF] != 0u; }

__device__ __forceinline__ void ld_pp(PP& p, const uint32_t* rec) {
  ld_pk(p.x, rec);
  ld_pk(p.y, rec + RY);
  ld_pk(p.z, rec + RZ);
  p.inf = rec_inf(rec);
}

__device__ __forceinline__ void st_pp(uint32_t* rec, const PP& p) {
  st_pk(rec, p.x);
  st_pk(rec + RY, p.y);
  st_pk(rec + RZ, p.z);
  *reinterpret_cast<uint4*>(rec + RINF) = make_uint4(p.inf ? 1u : 0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void set_pk(uint32_t w[PW], uint32_t v) {
  w[0] = v;
#pragma unroll
  for (int i = 1; i < PW; ++i) w[i] = 0u;
}

// the identity as the reference keeps it: (1, 1, 0), flagged
__device__ __forceinline__ void set_identity(PP& p) {
  set_pk(p.x, 1u);
  set_pk(p.y, 1u);
  set_pk(p.z, 0u);
  p.inf = true;
}

// the boundary tree's padding: (0, 0, 0), flagged
__device__ __forceinline__ void set_padding(PP& p) {
  set_pk(p.x, 0u);
  set_pk(p.y, 0u);
  set_pk(p.z, 0u);
  p.inf = true;
}

// --- reduction terms on the tensor cores ------------------------------------

// This lane's product columns (a b, or a^2) into its slot row, four at a
// time: quad q of element e at quad (q + ((e >> 1) & 3)) mod 12 of its row.
template <bool SQ>
__device__ __forceinline__ void put_T(const Red& r, const uint32_t a[L], const uint32_t b[L]) {
  uint32_t* row = r.slot + r.lane * SWL;
  const int rot = (r.lane >> 1) & 3;
#pragma unroll
  for (int q = 0; q < 11; ++q) {
    uint32_t c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * q + u;
      uint32_t t = 0u;
      if (SQ) {
#pragma unroll
        for (int i = 0; i < L; ++i)
          if (k - i > i && k - i < L) t += a[i] * a[k - i];
        t += t;
        if (k % 2 == 0 && k / 2 < L) t += a[k / 2] * a[k / 2];
      } else {
#pragma unroll
        for (int i = 0; i < L; ++i)
          if (k - i >= 0 && k - i < L) t += a[i] * b[k - i];
      }
      c[u] = t;
    }
    const int pq = q + rot < 12 ? q + rot : q + rot - 12;
    *reinterpret_cast<uint4*>(row + 4 * pq) = make_uint4(c[0], c[1], c[2], c[3]);
  }
}

// A += mat(scale) . bytes of the warp's first 8 NB slot rows (NB = 4: all
// 32; the chains that one warp runs for at most 16 lanes take NB = 2).
// Thread (g, t) reads quads 3t..3t+2 of element 8 nb + g: words 12t + 2s +
// {0, 1} are its B fragment of step s (L's K order, fragment_matrix_l);
// quad 11 holds no column and meets zero rows of the matrix.
template <int NB>
__device__ __forceinline__ void mma_slot(Acc& A, const Red& r, int scale) {
  const int g = r.lane >> 2, t = r.lane & 3;
  const uint4* mat = r.mats + scale * MATQ;
  const int rot = (g >> 1) & 3;
#pragma unroll 1
  for (int kq = 0; kq < 3; ++kq) {
    const int q = 3 * t + kq + rot;
    const int pq = q < 12 ? q : q - 12;
    uint4 b[NB];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) b[nb] = *reinterpret_cast<const uint4*>(r.slot + (nb * 8 + g) * SWL + 4 * pq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * kq + h;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const uint4 a = mat[(m * 6 + s) * 32 + r.lane];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_u8(A.d[m][nb], a, h ? b[nb].z : b[nb].x, h ? b[nb].w : b[nb].y);
      }
    }
  }
}

template <int NB>
__device__ __forceinline__ void tprod(Acc& A, const Red& r, const uint32_t a[L], const uint32_t b[L], int s) {
  put_T<false>(r, a, b);
  __syncwarp();
  mma_slot<NB>(A, r, s);
  __syncwarp();
}

template <int NB>
__device__ __forceinline__ void tsqr(Acc& A, const Red& r, const uint32_t a[L], int s) {
  put_T<true>(r, a, a);
  __syncwarp();
  mma_slot<NB>(A, r, s);
  __syncwarp();
}

__device__ __forceinline__ void fin(const Field& F, const Acc& A, const Red& r, uint32_t out[L]) {
  acc_finish(F, A, Warp{r.slot, r.lane}, out);
}

// out may alias a or b
template <int NB>
__device__ __forceinline__ void mulr(const Field& F, const Red& r, const uint32_t a[L], const uint32_t b[L],
                                     uint32_t out[L]) {
  Acc A;
  acc_zero(A);
  tprod<NB>(A, r, a, b, S1);
  fin(F, A, r, out);
}

template <int NB>
__device__ __forceinline__ void sqrr(const Field& F, const Red& r, const uint32_t a[L], uint32_t out[L]) {
  Acc A;
  acc_zero(A);
  tsqr<NB>(A, r, a, S1);
  fin(F, A, r, out);
}

// --- point formulas (warp-collective) ----------------------------------------

// madd-2007-bl: p += the leaf (qx, qy at leaf, never the identity); same:
// p equals the leaf. Values that wait stay packed.
__device__ __forceinline__ void madd(const Field& F, const Red& r, PP& p, const uint32_t* __restrict__ leaf,
                                     bool& same) {
  uint32_t z[L], z1z1[L], a[L], t[L], h[L], rh[L];
  PP out;
  unpack(z, p.z);
  sqrr<4>(F, r, z, z1z1);
  {
    uint32_t w[PW];
    ldg_pk(w, leaf);
    unpack(a, w);
  }
  mulr<4>(F, r, a, z1z1, t);  // u2
  unpack(a, p.x);
  sub13(F, t, a, h);
  {
    uint32_t w[PW];
    ldg_pk(w, leaf + RY);
    unpack(a, w);
  }
  mulr<4>(F, r, a, z, t);
  mulr<4>(F, r, t, z1z1, t);  // s2
  unpack(a, p.y);
  sub13(F, t, a, rh);
  add13(F, z, h, t);
  Acc A;
  acc_zero(A);
  tsqr<4>(A, r, t, S1);
  tsqr<4>(A, r, z, SM1);
  tsqr<4>(A, r, h, SM1);
  fin(F, A, r, t);  // z3 = (z1 + h)^2 - z1^2 - h^2
  pack(out.z, t);
  const bool hz = is_zero13(F, h), rz = is_zero13(F, rh);
  uint32_t hh[L];
  sqrr<4>(F, r, h, hh);
  unpack(a, p.x);
  acc_zero(A);
  tsqr<4>(A, r, rh, S4);
  tprod<4>(A, r, h, hh, SM4);
  tprod<4>(A, r, a, hh, SM8);
  fin(F, A, r, t);  // x3 = 4 rh^2 - 4 h^3 - 8 x1 h^2
  pack(out.x, t);
  acc_zero(A);
  tprod<4>(A, r, a, hh, S4);
  fin(F, A, r, a);  // v = 4 x1 h^2
  sub13(F, a, t, a);  // v - x3
  acc_zero(A);
  tprod<4>(A, r, h, hh, S4);
  fin(F, A, r, t);  // j = 4 h^3
  unpack(hh, p.y);
  acc_zero(A);
  tprod<4>(A, r, rh, a, S2);
  tprod<4>(A, r, hh, t, SM2);
  fin(F, A, r, t);  // y3 = 2 rh (v - x3) - 2 y1 j
  pack(out.y, t);
  same = hz && rz && !p.inf;
  out.inf = hz && !rz && !p.inf;
  if (p.inf) {
    ldg_pk(out.x, leaf);
    ldg_pk(out.y, leaf + RY);
    set_pk(out.z, 1u);
  }
  p = out;
}

// add-2007-bl, complete by flag selects: out = P + Q of two records, with
// the flags pinf and qinf (the exclusive scans and the boundaries drop the
// second operand's flag, as the reference does).
template <int NB>
__device__ __forceinline__ void add_rec(const Field& F, const Red& r, const uint32_t* P, bool pinf,
                                        const uint32_t* Q, bool qinf, PP& out, bool& same) {
  uint32_t a[L], b[L], z1z1[L], z2z2[L], s1[L], rh[L], t[L];
  ld_el(a, P + RZ);
  sqrr<NB>(F, r, a, z1z1);
  ld_el(b, Q + RZ);
  sqrr<NB>(F, r, b, z2z2);
  ld_el(t, P + RY);
  mulr<NB>(F, r, t, b, t);
  mulr<NB>(F, r, t, z2z2, s1);  // s1 = y1 z2^3
  ld_el(t, Q + RY);
  mulr<NB>(F, r, t, a, t);
  mulr<NB>(F, r, t, z1z1, t);  // s2 = y2 z1^3
  sub13(F, t, s1, rh);
  Acc A;
  add13(F, a, b, t);
  acc_zero(A);
  tsqr<NB>(A, r, t, S1);
  tsqr<NB>(A, r, a, SM1);
  tsqr<NB>(A, r, b, SM1);
  fin(F, A, r, b);  // (z1 + z2)^2 - z1^2 - z2^2
  ld_el(t, P);
  mulr<NB>(F, r, t, z2z2, a);  // u1
  ld_el(t, Q);
  mulr<NB>(F, r, t, z1z1, t);  // u2
  uint32_t h[L];
  sub13(F, t, a, h);
  mulr<NB>(F, r, b, h, t);  // z3
  pack(out.z, t);
  const bool hz = is_zero13(F, h), rz = is_zero13(F, rh);
  sqrr<NB>(F, r, h, b);  // hh
  acc_zero(A);
  tsqr<NB>(A, r, rh, S4);
  tprod<NB>(A, r, h, b, SM4);
  tprod<NB>(A, r, a, b, SM8);
  fin(F, A, r, t);  // x3
  pack(out.x, t);
  acc_zero(A);
  tprod<NB>(A, r, a, b, S4);
  fin(F, A, r, a);  // v
  sub13(F, a, t, a);  // v - x3
  acc_zero(A);
  tprod<NB>(A, r, h, b, S4);
  fin(F, A, r, t);  // j
  acc_zero(A);
  tprod<NB>(A, r, rh, a, S2);
  tprod<NB>(A, r, s1, t, SM2);
  fin(F, A, r, t);  // y3
  pack(out.y, t);
  const bool both = !pinf && !qinf;
  same = hz && rz && both;
  out.inf = hz && !rz && both;
  if (pinf) {  // the reference's select_l(p.inf, q, out), then select_l(q.inf & ~p.inf, p, out)
    ld_pk(out.x, Q);
    ld_pk(out.y, Q + RY);
    ld_pk(out.z, Q + RZ);
    out.inf = qinf;
  } else if (qinf) {
    ld_pk(out.x, P);
    ld_pk(out.y, P + RY);
    ld_pk(out.z, P + RZ);
    out.inf = false;
  }
}

// dbl-2009-l in place (the identity flag is kept by the caller).
template <int NB>
__device__ __forceinline__ void dbl(const Field& F, const Red& r, uint32_t x[L], uint32_t y[L], uint32_t z[L]) {
  uint32_t b[L], d[L], t[L];
  sqrr<NB>(F, r, y, b);
  Acc A;
  acc_zero(A);
  tprod<NB>(A, r, y, z, S2);
  fin(F, A, r, z);  // z3 = 2 y z
  add13(F, x, b, t);
  acc_zero(A);
  tsqr<NB>(A, r, t, S2);
  tsqr<NB>(A, r, x, SM2);
  tsqr<NB>(A, r, b, SM2);
  fin(F, A, r, d);  // d = 2 ((x + b)^2 - x^2 - b^2)
  acc_zero(A);
  tsqr<NB>(A, r, x, S3);
  fin(F, A, r, t);  // e = 3 x^2
  sqrr<NB>(F, r, t, x);
  add13(F, d, d, y);
  sub13(F, x, y, x);  // x3 = e^2 - 2 d
  sub13(F, d, x, d);  // d - x3
  acc_zero(A);
  tprod<NB>(A, r, t, d, S1);
  tsqr<NB>(A, r, b, SM8);
  fin(F, A, r, y);  // y3 = e (d - x3) - 8 b^2
}

template <int NB>
__device__ __forceinline__ void dbl_pp(const Field& F, const Red& r, PP& p) {
  uint32_t x[L], y[L], z[L];
  unpack(x, p.x);
  unpack(y, p.y);
  unpack(z, p.z);
  dbl<NB>(F, r, x, y, z);
  pack(p.x, x);
  pack(p.y, y);
  pack(p.z, z);
}

// One copy of the addition and of the doubling, called by every kernel but
// the scan (the code of a formula is ~20k instructions): records in,
// records out (written where ``store``), so that no array crosses the call.
template <int NB>
__device__ __noinline__ bool add_mem(const Field& F, Red r, const uint32_t* P, bool pinf, const uint32_t* Q,
                                     bool qinf, uint32_t* dst, bool store) {
  PP out;
  bool same;
  add_rec<NB>(F, r, P, pinf, Q, qinf, out, same);
  if (store) st_pp(dst, out);
  return same;
}

// dst = 2 P (the flag kept); dst may be P
template <int NB>
__device__ __noinline__ void dbl_mem(const Field& F, Red r, const uint32_t* P, uint32_t* dst, bool store) {
  PP p;
  ld_pp(p, P);
  dbl_pp<NB>(F, r, p);
  if (store) st_pp(dst, p);
}

// --- kernels ------------------------------------------------------------------

__device__ __forceinline__ i64 thread_index() { return static_cast<i64>(blockIdx.x) * THREADS + threadIdx.x; }

// Loops of warp-collective work over count items: every lane of a warp runs
// the same iterations (lanes past count compute on the last item).
#define FOR_ITEMS(count)                                                                                      \
  for (i64 base_ = static_cast<i64>(blockIdx.x) * THREADS; base_ < (count);                                   \
       base_ += static_cast<i64>(gridDim.x) * THREADS)

// Elementwise point operations on records (comparisons with the plain
// version): 0 add, 1 madd (q holds bases), 2 double.
__global__ void __launch_bounds__(THREADS) k_point_op(const __grid_constant__ Ctx C, int op, uint32_t* __restrict__ out,
                                                      const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                                                      int* flag, i64 n) {
  const Red r = setup(C);
  FOR_ITEMS(n) {
    const i64 i = base_ + threadIdx.x;
    const i64 ic = i < n ? i : n - 1;
    const uint32_t* P = p + ic * RW;
    bool same = false;
    if (op == 0) {
      same = add_mem<4>(C.F, r, P, rec_inf(P), q + ic * RW, rec_inf(q + ic * RW), out + i * RW, i < n);
    } else if (op == 1) {
      PP a;
      ld_pp(a, P);
      madd(C.F, r, a, q + ic * BW, same);
      if (i < n) st_pp(out + i * RW, a);
    } else {
      dbl_mem<4>(C.F, r, P, out + i * RW, i < n);
    }
    if (i < n && same) atomicOr(flag, 1);
  }
}

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

// One thread per (window, lane) of every window: S mixed additions from
// the identity over sorted positions lane S .. lane S + S - 1, each leaf
// read through perm. Where a position ends its digit's run (and the digit
// is below B - 1, so some boundary reads it) the prefix is stored at
// within[w B + digit]; the lane total at totals[w Lw + lane].
__global__ void __launch_bounds__(THREADS, SCAN_BLOCKS) k_scan(const __grid_constant__ Ctx C, uint32_t* __restrict__ within,
                                                     uint32_t* __restrict__ totals, const uint32_t* __restrict__ bases,
                                                     const int* __restrict__ sd, const int* __restrict__ perm, i64 n,
                                                     int W, i64 Lw, i64 S, int B, int* flag) {
  const Red r = setup(C);
  const i64 count = W * Lw;
  const i64 i = thread_index();
  const bool valid = i < count;
  const i64 ic = valid ? i : count - 1;
  const i64 w = ic / Lw, lane = ic % Lw;
  const int* srow = sd + w * n;
  const int* prow = perm + w * n;
  PP acc;
  set_identity(acc);
  bool any = false;
  const i64 pos0 = lane * S;
  int idx = prow[pos0], d = srow[pos0];
#pragma unroll 1
  for (i64 s = 0; s < S; ++s) {
    const i64 pos = pos0 + s;
    const int dn = pos + 1 < n ? srow[pos + 1] : -1;
    const int idxn = s + 1 < S ? prow[pos + 1] : idx;
    const uint32_t* nxt = bases + static_cast<i64>(idxn) * BW;
    asm volatile("prefetch.L2 [%0];" ::"l"(nxt));
    asm volatile("prefetch.L2 [%0];" ::"l"(nxt + BW - 1));
    bool same;
    madd(C.F, r, acc, bases + static_cast<i64>(idx) * BW, same);
    any = any || same;
    if (valid && d != dn && d < B - 1) st_pp(within + (w * B + d) * RW, acc);
    idx = idxn;
    d = dn;
  }
  if (valid) {
    st_pp(totals + i * RW, acc);
    if (any) atomicOr(flag, 1);
  }
}

// Exclusive scan over blen of each of nb blocks of records (their identity
// flags dropped, as the reference's): offs (nb blen) and tots (nb). NB: the
// n8 groups of a warp's lanes that hold blocks (nb <= 16: 2).
template <int NB>
__global__ void __launch_bounds__(THREADS) k_exscan(const __grid_constant__ Ctx C, uint32_t* __restrict__ offs,
                                                    uint32_t* __restrict__ tots, const uint32_t* __restrict__ in,
                                                    i64 nb, i64 blen, int* flag) {
  const Red r = setup(C);
  const i64 i = thread_index();
  const bool valid = i < nb;
  const i64 ic = valid ? i : nb - 1;
  if (valid) {
    PP id;
    set_identity(id);
    st_pp(offs + ic * blen * RW, id);
  }
  bool any = false;
  for (i64 b = 0; b < blen; ++b) {
    const uint32_t* P = offs + (ic * blen + b) * RW;
    uint32_t* dst = b + 1 < blen ? offs + (ic * blen + b + 1) * RW : tots + ic * RW;
    any = add_mem<NB>(C.F, r, P, rec_inf(P), in + (ic * blen + b) * RW, false, dst, valid) || any;
  }
  if (valid && any) atomicOr(flag, 1);
}

// off[w Lw + a Bz + b] = block offset [w A + a] + within-block offset
__global__ void __launch_bounds__(THREADS) k_offsets(const __grid_constant__ Ctx C, uint32_t* __restrict__ off,
                                                     const uint32_t* __restrict__ bo, const uint32_t* __restrict__ wo,
                                                     i64 count, i64 Bz, int* flag) {
  const Red r = setup(C);
  FOR_ITEMS(count) {
    const i64 i = base_ + threadIdx.x;
    const i64 ic = i < count ? i : count - 1;
    const uint32_t *P = bo + (ic / Bz) * RW, *Q = wo + ic * RW;
    if (add_mem<4>(C.F, r, P, rec_inf(P), Q, rec_inf(Q), off + i * RW, i < count) && i < count) atomicOr(flag, 1);
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

// bacc[w m + k], k < B - 1: the prefix sum of the points with digit <= k of
// window w, lane offset + within-lane prefix; the identity where no digit
// is <= k; k >= B - 1: the tree's padding.
__global__ void __launch_bounds__(THREADS) k_boundaries(const __grid_constant__ Ctx C, uint32_t* __restrict__ bacc,
                                                        const uint32_t* __restrict__ within,
                                                        const uint32_t* __restrict__ off, const int* __restrict__ sd,
                                                        int W, i64 n, i64 Lw, i64 S, int B, i64 m, int* flag) {
  const Red r = setup(C);
  const i64 count = W * m;
  FOR_ITEMS(count) {
    const i64 i = base_ + threadIdx.x;
    const i64 ic = i < count ? i : count - 1;
    const i64 w = ic / m, k = ic % m;
    const int t = static_cast<int>(k < B - 1 ? k + 1 : B - 1);
    const int* row = sd + w * n;
    const i64 pos = lower_bound(row, n, t) - 1;
    const bool real = pos >= 0 && k < B - 1;
    const i64 posc = pos < 0 ? 0 : pos;
    const uint32_t* P = off + (w * Lw + posc / S) * RW;
    bool same = false;
    if (__any_sync(FULL, real))
      same = add_mem<4>(C.F, r, P, rec_inf(P), within + (w * B + row[posc]) * RW, false, bacc + i * RW,
                     real && i < count);
    if (i < count && !real) {
      PP p;
      if (k >= B - 1)
        set_padding(p);
      else
        set_identity(p);
      st_pp(bacc + i * RW, p);
    }
    if (i < count && same && real) atomicOr(flag, 1);
  }
}

__device__ __forceinline__ bool same_words(const uint32_t* P, const uint32_t* Q) {
  bool eq = true;
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    uint32_t a[PW], b[PW];
    ld_pk(a, P + c * RY);
    ld_pk(b, Q + c * RY);
#pragma unroll
    for (int j = 0; j < PW; ++j) eq = eq && a[j] == b[j];
  }
  return eq;
}

__device__ __forceinline__ void copy_rec(uint32_t* dst, const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < RW / 4; ++j) reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(src)[j];
}

// One level of the boundary tree: dst[w h + k] = src[w 2h + k] + src[w 2h +
// k + h], k < h = half. Boundaries that no digit separates hold equal prefix
// sums (every one past a window's largest digit holds its total), so where
// the inputs are equal the sum is the doubling of the first, and no flag is
// raised. A lane whose inputs are the same words doubles without adding; a
// warp adds only when some lane needs it.
__global__ void __launch_bounds__(THREADS) k_tree(const __grid_constant__ Ctx C, uint32_t* __restrict__ dst,
                                                  const uint32_t* __restrict__ src, int W, i64 half) {
  const Red r = setup(C);
  const i64 count = W * half;
  FOR_ITEMS(count) {
    const i64 i = base_ + threadIdx.x;
    const i64 ic = i < count ? i : count - 1;
    const i64 w = ic / half, k = ic % half;
    const uint32_t *P = src + (w * 2 * half + k) * RW, *Q = P + half * RW;
    uint32_t* D = dst + i * RW;
    const bool pinf = rec_inf(P), qinf = rec_inf(Q);
    const bool eq = !pinf && !qinf && same_words(P, Q);
    const bool sum = !pinf && !qinf && !eq;
    bool same = false;
    if (__any_sync(FULL, sum)) same = add_mem<4>(C.F, r, P, pinf, Q, qinf, D, sum && i < count);
    const bool twice = eq || (sum && same);
    if (__any_sync(FULL, twice)) dbl_mem<4>(C.F, r, P, D, twice && i < count);
    if (i < count && (pinf || qinf)) copy_rec(D, pinf ? Q : P);
  }
}

// G_w = (B - 1) * Total - sum PS for every window w, one thread each; the
// running sums in this thread's three scratch records (NB as k_exscan's).
template <int NB>
__global__ void __launch_bounds__(THREADS) k_window(const __grid_constant__ Ctx C, uint32_t* __restrict__ gw,
                                                    uint32_t* __restrict__ scratch, const uint32_t* __restrict__ root,
                                                    const uint32_t* __restrict__ grand, int W, int c, int* flag) {
  const Red r = setup(C);
  const i64 i = thread_index();
  const i64 ic = i < W ? i : W - 1;
  uint32_t* acc_r = scratch + i * 3 * RW;
  uint32_t* cur_r = acc_r + RW;
  uint32_t* s_r = cur_r + RW;
  PP s;
  set_identity(s);
  st_pp(acc_r, s);
  copy_rec(cur_r, grand + ic * RW);
  ld_pp(s, root + ic * RW);
  {
    uint32_t y[L], zero[L];
    unpack(y, s.y);
    set_small(zero, 0u);
    sub13(C.F, zero, y, y);
    pack(s.y, y);
  }
  st_pp(s_r, s);
  bool any = false;
  for (int k = 0; k < c; ++k) {
    any = add_mem<NB>(C.F, r, acc_r, rec_inf(acc_r), cur_r, rec_inf(cur_r), acc_r, true) || any;
    dbl_mem<NB>(C.F, r, cur_r, cur_r, true);
  }
  any = add_mem<NB>(C.F, r, acc_r, rec_inf(acc_r), s_r, s.inf, gw + ic * RW, i < W) || any;
  if (i < W && any) atomicOr(flag, 1);
}

// Horner over the W window sums, last window first: one warp (its first
// n8 group in the reductions: lane 0 is the one that counts), the doublings
// in registers, each addition through the lane's scratch record; lane 0
// stores the (3, 21, 1) result and flag.
__global__ void __launch_bounds__(32) k_horner(const __grid_constant__ Ctx C, uint32_t* __restrict__ out,
                                               uint8_t* __restrict__ out_inf, uint32_t* __restrict__ scratch,
                                               const uint32_t* __restrict__ gw, int W, int c, int* flag) {
  const Red r = setup(C);
  uint32_t* acc_r = scratch + r.lane * RW;
  PP acc;
  set_identity(acc);
  bool any = false;
  for (int win = W - 1; win >= 0; --win) {
#pragma unroll 1
    for (int k = 0; k < c; ++k) dbl_pp<1>(C.F, r, acc);
    st_pp(acc_r, acc);
    const uint32_t* Q = gw + win * RW;
    any = add_mem<2>(C.F, r, acc_r, acc.inf, Q, rec_inf(Q), acc_r, true) || any;
    ld_pp(acc, acc_r);
  }
  if (r.lane == 0) {
    uint32_t x[L], y[L], z[L];
    unpack(x, acc.x);
    unpack(y, acc.y);
    unpack(z, acc.z);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      out[l] = x[l];
      out[L + l] = y[l];
      out[2 * L + l] = z[l];
    }
    out_inf[0] = acc.inf ? 1 : 0;
    if (any) atomicOr(flag, 1);
  }
}

Ctx make_ctx(const Field* field, const uint4* mats) {
  Ctx C;
  C.F = *field;
  C.mats = mats;
  return C;
}

int blocks(i64 n) { return zk_blocks(n, THREADS); }

// one wave of blocks at two per SM, for the loops over many items
int wave(i64 n) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int b = blocks(n);
  return b < 2 * sms ? b : 2 * sms;
}

template <typename K>
int with_smem(K kernel) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
}

}  // namespace

typedef const Field* FieldP;
typedef const uint4* MatsP;

#define ZK_LAUNCH(kernel, grid, threads, ...)                               \
  do {                                                                      \
    const int e_ = with_smem(kernel);                                       \
    if (e_) return e_;                                                      \
    kernel<<<(grid), (threads), SMEM_BYTES, stream>>>(__VA_ARGS__);         \
    return static_cast<int>(cudaGetLastError());                            \
  } while (0)

ZK_EXPORT int zk_msm13_point_op(FieldP f, MatsP m, i64 op, uint32_t* out, const uint32_t* p, const uint32_t* q,
                                int* flag, i64 n, cudaStream_t stream) {
  ZK_LAUNCH(k_point_op, wave(n), THREADS, make_ctx(f, m), static_cast<int>(op), out, p, q, flag, n);
}

ZK_EXPORT int zk_msm13_digits(FieldP, MatsP, int* digits, const uint32_t* scalars, i64 n, i64 c, i64 W,
                              cudaStream_t stream) {
  k_digits<<<blocks(n * W), THREADS, 0, stream>>>(digits, scalars, n, static_cast<int>(c), static_cast<int>(W));
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_msm13_scan(FieldP f, MatsP m, uint32_t* within, uint32_t* totals, const uint32_t* bases,
                            const int* sd, const int* perm, i64 n, i64 W, i64 Lw, i64 S, i64 B, int* flag,
                            cudaStream_t stream) {
  ZK_LAUNCH(k_scan, blocks(W * Lw), THREADS, make_ctx(f, m), within, totals, bases, sd, perm, n,
            static_cast<int>(W), Lw, S, static_cast<int>(B), flag);
}

ZK_EXPORT int zk_msm13_exscan(FieldP f, MatsP m, uint32_t* offs, uint32_t* tots, const uint32_t* in, i64 nb, i64 blen,
                              int* flag, cudaStream_t stream) {
  if (nb <= 16) ZK_LAUNCH(k_exscan<2>, 1, 32, make_ctx(f, m), offs, tots, in, nb, blen, flag);
  ZK_LAUNCH(k_exscan<4>, blocks(nb), THREADS, make_ctx(f, m), offs, tots, in, nb, blen, flag);
}

ZK_EXPORT int zk_msm13_offsets(FieldP f, MatsP m, uint32_t* off, const uint32_t* bo, const uint32_t* wo, i64 count,
                               i64 Bz, int* flag, cudaStream_t stream) {
  ZK_LAUNCH(k_offsets, wave(count), THREADS, make_ctx(f, m), off, bo, wo, count, Bz, flag);
}

ZK_EXPORT int zk_msm13_boundaries(FieldP f, MatsP m, uint32_t* bacc, const uint32_t* within, const uint32_t* off,
                                  const int* sd, i64 W, i64 n, i64 Lw, i64 S, i64 B, i64 mm, int* flag,
                                  cudaStream_t stream) {
  ZK_LAUNCH(k_boundaries, wave(W * mm), THREADS, make_ctx(f, m), bacc, within, off, sd, static_cast<int>(W), n, Lw,
            S, static_cast<int>(B), mm, flag);
}

ZK_EXPORT int zk_msm13_tree(FieldP f, MatsP m, uint32_t* dst, const uint32_t* src, i64 W, i64 half,
                            cudaStream_t stream) {
  ZK_LAUNCH(k_tree, wave(W * half), THREADS, make_ctx(f, m), dst, src, static_cast<int>(W), half);
}

ZK_EXPORT int zk_msm13_window(FieldP f, MatsP m, uint32_t* gw, uint32_t* scratch, const uint32_t* root,
                              const uint32_t* grand, i64 W, i64 c, int* flag, cudaStream_t stream) {
  if (W <= 16)
    ZK_LAUNCH(k_window<2>, 1, 32, make_ctx(f, m), gw, scratch, root, grand, static_cast<int>(W), static_cast<int>(c),
              flag);
  ZK_LAUNCH(k_window<4>, blocks(W), THREADS, make_ctx(f, m), gw, scratch, root, grand, static_cast<int>(W),
            static_cast<int>(c), flag);
}

ZK_EXPORT int zk_msm13_horner(FieldP f, MatsP m, uint32_t* out, uint8_t* out_inf, uint32_t* scratch,
                              const uint32_t* gw, i64 W, i64 c, int* flag, cudaStream_t stream) {
  ZK_LAUNCH(k_horner, 1, 32, make_ctx(f, m), out, out_inf, scratch, gw, static_cast<int>(W), static_cast<int>(c),
            flag);
}
