// Kernel J's device functions: the lazy 13-bit-limb prime field of
// zkevm_tpu/ff/lazy13.py, one element per thread, 21 u32 limbs in
// registers (little-endian 13-bit limbs, standard form, value < 2^263,
// limbs < 2^13 + 2^6).
//
// A product is the 441 schoolbook limb products summed into 41 u32
// columns (< 2^31, no per-product splitting). The reduction mod p is one
// constant u8 matrix product on the int8 tensor cores: for a warp's 32
// elements, each product column word is stored to shared memory as its own
// four bytes, and mma.sync.m16n8k32 (u8 x u8 -> s32) multiplies the
// reduction matrix (42 rows padded to 48, the 164 bytes of a term padded
// to 192) by the warp's 32 columns of bytes, 8 elements per MMA. A
// combine_reduce of several signed-scaled terms accumulates each term's
// product with its own scaled matrix into the same s32 accumulators (the
// reference concatenates the matrices; the sums are the same integers).
// The accumulators go back through shared memory to their element's
// thread, which runs the carry rounds and the 2^262 fold in registers.
//
// The matrices are read as A fragments, pre-arranged on the host (one
// 16-byte load per lane per tile), from global memory through L1; the
// field constants arrive as a kernel parameter (constant bank). Every
// function that reduces is warp-collective: all 32 lanes must call it, in
// the same order (the kernels clamp lanes beyond n instead of returning).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace l13 {

constexpr int L = 21;             // limbs
constexpr int NP = 41;            // product columns
constexpr int KW = 48;            // column words per element incl. the zero pad (K = 192 bytes)
constexpr int SW = 52;            // shared-memory words per element (bank-conflict-free B loads)
constexpr int DS = 43;            // words per element of the accumulator exchange
constexpr int SLOT_WORDS = 32 * SW;  // shared memory of one warp
constexpr uint32_t M13 = 0x1FFF;

struct Field {
  uint32_t p[L];       // p
  uint32_t w262[L];    // 2^262 mod p
  uint32_t kpt[L];     // borrow-absorbed KP~ (sub13)
  uint32_t kpl[L];     // strict limbs of KP
  uint32_t kpi[8][L];  // KP + i p, i < 8 (zero patterns)
  uint32_t mu;         // Barrett constant
  uint32_t mu_k;
};

// Reduction matrices by scale, in A-fragment order (3 x 6 x 32 uint4 each).
enum Scale { S1 = 0, S2, S3, S4, SM1, SM2, SM4, SM8, NSCALES };
struct Mats {
  const uint4* s[NSCALES];
};

struct Warp {
  uint32_t* slot;  // SLOT_WORDS words of shared memory
  int lane;
};

struct Acc {
  uint32_t d[3][4][4];  // [m16 tile][n8 group][fragment register]
};

__device__ __forceinline__ void acc_zero(Acc& A) {
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) A.d[m][nb][i] = 0u;
}

__device__ __forceinline__ void mma_u8(uint32_t d[4], const uint4 a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Accumulate mat @ bytes(T) for the warp's 32 elements (T: this lane's columns).
__device__ __forceinline__ void acc_T(Acc& A, const Warp& w, const uint32_t T[NP],
                                      const uint4* __restrict__ mat) {
  uint32_t* row = w.slot + w.lane * SW;
#pragma unroll
  for (int j = 0; j < NP; ++j) row[j] = T[j];
#pragma unroll
  for (int j = NP; j < KW; ++j) row[j] = 0u;
  __syncwarp();
  const int g = w.lane >> 2, t = w.lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < 6; ++ks) {
    uint32_t b[4][2];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const uint32_t* col = w.slot + (nb * 8 + g) * SW + ks * 8;
      b[nb][0] = col[t];
      b[nb][1] = col[4 + t];
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const uint4 a = __ldg(mat + (m * 6 + ks) * 32 + w.lane);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) mma_u8(A.d[m][nb], a, b[nb][0], b[nb][1]);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void round13(uint32_t r[L]) {
#pragma unroll
  for (int l = L - 1; l > 0; --l) r[l] = (r[l] & M13) + (r[l - 1] >> 13);
  r[0] &= M13;
}

__device__ __forceinline__ void fold_top(const Field& F, uint32_t r[L]) {
  const uint32_t e = r[L - 1] >> 2;
  r[L - 1] &= 3u;
#pragma unroll
  for (int l = 0; l < L; ++l) r[l] += e * F.w262[l];
}

__device__ __forceinline__ void carry_fold(const Field& F, uint32_t r[L]) {
  round13(r);
  round13(r);
  fold_top(F, r);
  round13(r);
  round13(r);
}

// The accumulated s32 sums back to this lane's element, then the carries.
__device__ __forceinline__ void acc_finish(const Field& F, const Acc& A, const Warp& w, uint32_t out[L]) {
  uint32_t* d = w.slot;
  const int g = w.lane >> 2, t = w.lane & 3;
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m * 16 + g + ((i & 2) ? 8 : 0);
        const int e = nb * 8 + 2 * t + (i & 1);
        if (r < 2 * L) d[e * DS + r] = A.d[m][nb][i];
      }
  __syncwarp();
#pragma unroll
  for (int l = 0; l < L; ++l) out[l] = d[w.lane * DS + 2 * l] + (d[w.lane * DS + 2 * l + 1] << 8);
  __syncwarp();
  carry_fold(F, out);
}

__device__ __forceinline__ void prod_T(const uint32_t a[L], const uint32_t b[L], uint32_t T[NP]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) T[k] = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < L; ++j) T[i + j] += a[i] * b[j];
}

__device__ __forceinline__ void sqr_T(const uint32_t a[L], uint32_t T[NP]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) T[k] = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    T[2 * i] += a[i] * a[i];
    const uint32_t ad = a[i] + a[i];
#pragma unroll
    for (int j = i + 1; j < L; ++j) T[i + j] += ad * a[j];
  }
}

__device__ __forceinline__ void term_prod(Acc& A, const Warp& w, const uint32_t a[L], const uint32_t b[L],
                                          const uint4* mat) {
  uint32_t T[NP];
  prod_T(a, b, T);
  acc_T(A, w, T, mat);
}

__device__ __forceinline__ void term_sqr(Acc& A, const Warp& w, const uint32_t a[L], const uint4* mat) {
  uint32_t T[NP];
  sqr_T(a, T);
  acc_T(A, w, T, mat);
}

// out may alias a or b in every op below.
__device__ __forceinline__ void mul13(const Field& F, const Mats& M, const Warp& w, const uint32_t a[L],
                                      const uint32_t b[L], uint32_t out[L]) {
  Acc A;
  acc_zero(A);
  term_prod(A, w, a, b, M.s[S1]);
  acc_finish(F, A, w, out);
}

__device__ __forceinline__ void sqr13(const Field& F, const Mats& M, const Warp& w, const uint32_t a[L],
                                      uint32_t out[L]) {
  Acc A;
  acc_zero(A);
  term_sqr(A, w, a, M.s[S1]);
  acc_finish(F, A, w, out);
}

__device__ __forceinline__ void add13(const Field& F, const uint32_t a[L], const uint32_t b[L], uint32_t out[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) out[l] = a[l] + b[l];
  round13(out);
  fold_top(F, out);
  round13(out);
}

__device__ __forceinline__ void sub13(const Field& F, const uint32_t a[L], const uint32_t b[L], uint32_t out[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) out[l] = a[l] + F.kpt[l] - b[l];
  round13(out);
  fold_top(F, out);
  round13(out);
}

__device__ __forceinline__ void ripple(uint32_t r[L]) {
  uint32_t carry = 0u;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint32_t v = r[l] + carry;
    r[l] = v & M13;
    carry = v >> 13;
  }
}

// Strict limbs of V - m p + KP, V the exact value of a: in [KP, KP + 7p).
__device__ __forceinline__ void barrett_sub(const Field& F, const uint32_t a[L], uint32_t t[L]) {
  const uint32_t v_hi = a[19] + (a[20] << 13);
  const uint32_t m = (v_hi * F.mu) >> F.mu_k;
  uint32_t mp[L];
#pragma unroll
  for (int l = 0; l < L; ++l) mp[l] = m * F.p[l];
  round13(mp);
  round13(mp);
#pragma unroll
  for (int l = 0; l < L; ++l) t[l] = a[l] + F.kpt[l] - mp[l];
  ripple(t);
}

__device__ __forceinline__ bool is_zero13(const Field& F, const uint32_t a[L]) {
  uint32_t t[L];
  barrett_sub(F, a, t);
  bool hit = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bool eq = true;
#pragma unroll
    for (int l = 0; l < L; ++l) eq = eq && (t[l] == F.kpi[i][l]);
    hit = hit || eq;
  }
  return hit;
}

// r -= c with a borrow ripple; returns the final borrow (1 when r < c).
__device__ __forceinline__ uint32_t sub_ripple(uint32_t r[L], const uint32_t c[L]) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint32_t v = r[l] + (1u << 13) - c[l] - borrow;
    r[l] = v & M13;
    borrow = 1u - (v >> 13);
  }
  return borrow;
}

__device__ __forceinline__ void canon13(const Field& F, const uint32_t a[L], uint32_t out[L]) {
  barrett_sub(F, a, out);
  sub_ripple(out, F.kpl);
#pragma unroll 1
  for (int k = 0; k < 7; ++k) {
    uint32_t d[L];
#pragma unroll
    for (int l = 0; l < L; ++l) d[l] = out[l];
    const uint32_t borrow = sub_ripple(d, F.p);
#pragma unroll
    for (int l = 0; l < L; ++l) out[l] = borrow ? out[l] : d[l];
  }
}

__device__ __forceinline__ void set_small(uint32_t r[L], uint32_t v) {
  r[0] = v;
#pragma unroll
  for (int l = 1; l < L; ++l) r[l] = 0u;
}

__device__ __forceinline__ void copy13(uint32_t dst[L], const uint32_t src[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) dst[l] = src[l];
}

// limbs-first (L, n) arrays: limb l of element i at p[l * n + i]
__device__ __forceinline__ void load13(uint32_t r[L], const uint32_t* __restrict__ p, i64 i, i64 n) {
#pragma unroll
  for (int l = 0; l < L; ++l) r[l] = p[l * n + i];
}

__device__ __forceinline__ void store13(uint32_t* __restrict__ p, const uint32_t r[L], i64 i, i64 n) {
#pragma unroll
  for (int l = 0; l < L; ++l) p[l * n + i] = r[l];
}

}  // namespace l13
