// BN254 Fr / Fq arithmetic on 8 x 32-bit little-endian words, Montgomery
// form with R = 2^256, always canonical (< p). Device functions shared by
// every kernel that does field arithmetic (A, B, C, E, F, G, H, I, M).
//
// The arithmetic is PTX carry chains (mad.lo.cc / madc.hi.cc / addc /
// subc), one asm text per operation for both fields, the modulus and
// -p^{-1} mod 2^32 passed as immediate operands ("n") from Mod<F>. The
// Montgomery product is CIOS over 32-bit words with one accumulator: each
// row adds a * b_i (a low pass and a high pass) and then m p, which clears
// the low word; 264 multiply instructions. p < 2^254, so sums of two
// canonical values never carry out of 256 bits and one conditional
// subtraction canonicalises every result. Each asm statement holds whole
// carry chains, so the carry flag is never live between statements and the
// compiler may interleave the statements of independent operations.
// tests/port/test_torch_affine.py runs this text through a model of its
// opcodes against integer arithmetic for both moduli.
#pragma once

#include "common.cuh"

namespace zk {

enum FieldId { FR = 0, FQ = 1 };

// R mod p: 1 in Montgomery form.
static __constant__ uint32_t kMontOne[2][8] = {
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, 0x7879462eu,
     0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu,
     0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
};

struct Fe {
  uint32_t w[8];
};

__device__ __forceinline__ Fe fe_load(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 lo = q[0], hi = q[1];
  Fe r;
  r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
  r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
  return r;
}

__device__ __forceinline__ void fe_store(uint32_t* p, const Fe& a) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  q[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = 0;
  return r;
}

template <int F>
__device__ __forceinline__ Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = kMontOne[F][i];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.w[i];
  return acc == 0;
}

// The field's constants as compile-time values, for the asm's immediates.
template <int F> struct Mod;
template <> struct Mod<FR> {
  static constexpr uint32_t p0 = 0xf0000001u, p1 = 0x43e1f593u, p2 = 0x79b97091u, p3 = 0x2833e848u,
                            p4 = 0x8181585du, p5 = 0xb85045b6u, p6 = 0xe131a029u, p7 = 0x30644e72u;
  static constexpr uint32_t ninv = 0xefffffffu;
};
template <> struct Mod<FQ> {
  static constexpr uint32_t p0 = 0xd87cfd47u, p1 = 0x3c208c16u, p2 = 0x6871ca8du, p3 = 0x97816a91u,
                            p4 = 0x8181585du, p5 = 0xb85045b6u, p6 = 0xe131a029u, p7 = 0x30644e72u;
  static constexpr uint32_t ninv = 0xe4866389u;
};

#define ZK_MOD_OPERANDS(F)                                                                   \
  "n"(Mod<F>::p0), "n"(Mod<F>::p1), "n"(Mod<F>::p2), "n"(Mod<F>::p3), "n"(Mod<F>::p4),       \
      "n"(Mod<F>::p5), "n"(Mod<F>::p6), "n"(Mod<F>::p7)

// t += a * bi: the low halves of the word products in one chain, the high
// halves one word up in a second.
__device__ __forceinline__ void fe_mont_row(uint32_t t[9], const Fe& a, uint32_t bi) {
  asm(
    "mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
    "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
    "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
    "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
    "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
    "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
    "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
    "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
    "addc.u32 %8, %8, 0;\n\t"
    "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
    "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
    "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
    "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
    "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
    "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
    "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
    "madc.hi.u32 %8, %16, %17, %8;\n\t"
    : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
    : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(bi));
}

// t += m p with m = t_0 (-p^{-1}) mod 2^32, which clears t_0.
template <int F>
__device__ __forceinline__ void fe_mont_redc(uint32_t t[9]) {
  asm(
    "{\n\t"
    ".reg .u32 zk_m;\n\t"
    "mul.lo.u32 zk_m, %0, %17;\n\t"
    "mad.lo.cc.u32 %0, zk_m, %9, %0;\n\t"
    "madc.lo.cc.u32 %1, zk_m, %10, %1;\n\t"
    "madc.lo.cc.u32 %2, zk_m, %11, %2;\n\t"
    "madc.lo.cc.u32 %3, zk_m, %12, %3;\n\t"
    "madc.lo.cc.u32 %4, zk_m, %13, %4;\n\t"
    "madc.lo.cc.u32 %5, zk_m, %14, %5;\n\t"
    "madc.lo.cc.u32 %6, zk_m, %15, %6;\n\t"
    "madc.lo.cc.u32 %7, zk_m, %16, %7;\n\t"
    "addc.u32 %8, %8, 0;\n\t"
    "mad.hi.cc.u32 %1, zk_m, %9, %1;\n\t"
    "madc.hi.cc.u32 %2, zk_m, %10, %2;\n\t"
    "madc.hi.cc.u32 %3, zk_m, %11, %3;\n\t"
    "madc.hi.cc.u32 %4, zk_m, %12, %4;\n\t"
    "madc.hi.cc.u32 %5, zk_m, %13, %5;\n\t"
    "madc.hi.cc.u32 %6, zk_m, %14, %6;\n\t"
    "madc.hi.cc.u32 %7, zk_m, %15, %7;\n\t"
    "madc.hi.u32 %8, zk_m, %16, %8;\n\t"
    "}\n\t"
    : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
    : ZK_MOD_OPERANDS(F), "n"(Mod<F>::ninv));
}

// t - p if t >= p (t < 2p).
template <int F>
__device__ __forceinline__ Fe fe_mont_reduce(const uint32_t t[8]) {
  Fe r;
  asm(
    "{\n\t"
    ".reg .u32 zk_d0, zk_d1, zk_d2, zk_d3, zk_d4, zk_d5, zk_d6, zk_d7, zk_x0, zk_x1, zk_x2, zk_x3, zk_x4, zk_x5, zk_x6, zk_x7, zk_bw, zk_nb, zk_zero;\n\t"
    "mov.u32 zk_zero, 0;\n\t"
    "sub.cc.u32 zk_d0, %8, %16;\n\t"
    "subc.cc.u32 zk_d1, %9, %17;\n\t"
    "subc.cc.u32 zk_d2, %10, %18;\n\t"
    "subc.cc.u32 zk_d3, %11, %19;\n\t"
    "subc.cc.u32 zk_d4, %12, %20;\n\t"
    "subc.cc.u32 zk_d5, %13, %21;\n\t"
    "subc.cc.u32 zk_d6, %14, %22;\n\t"
    "subc.cc.u32 zk_d7, %15, %23;\n\t"
    "subc.u32 zk_bw, zk_zero, zk_zero;\n\t"
    "not.b32 zk_nb, zk_bw;\n\t"
    "and.b32 zk_x0, %8, zk_bw;\n\t"
    "and.b32 zk_x1, %9, zk_bw;\n\t"
    "and.b32 zk_x2, %10, zk_bw;\n\t"
    "and.b32 zk_x3, %11, zk_bw;\n\t"
    "and.b32 zk_x4, %12, zk_bw;\n\t"
    "and.b32 zk_x5, %13, zk_bw;\n\t"
    "and.b32 zk_x6, %14, zk_bw;\n\t"
    "and.b32 zk_x7, %15, zk_bw;\n\t"
    "and.b32 zk_d0, zk_d0, zk_nb;\n\t"
    "and.b32 zk_d1, zk_d1, zk_nb;\n\t"
    "and.b32 zk_d2, zk_d2, zk_nb;\n\t"
    "and.b32 zk_d3, zk_d3, zk_nb;\n\t"
    "and.b32 zk_d4, zk_d4, zk_nb;\n\t"
    "and.b32 zk_d5, zk_d5, zk_nb;\n\t"
    "and.b32 zk_d6, zk_d6, zk_nb;\n\t"
    "and.b32 zk_d7, zk_d7, zk_nb;\n\t"
    "or.b32 %0, zk_x0, zk_d0;\n\t"
    "or.b32 %1, zk_x1, zk_d1;\n\t"
    "or.b32 %2, zk_x2, zk_d2;\n\t"
    "or.b32 %3, zk_x3, zk_d3;\n\t"
    "or.b32 %4, zk_x4, zk_d4;\n\t"
    "or.b32 %5, zk_x5, zk_d5;\n\t"
    "or.b32 %6, zk_x6, zk_d6;\n\t"
    "or.b32 %7, zk_x7, zk_d7;\n\t"
    "}\n\t"
    : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]), "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7])
    : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]), "r"(t[7]), ZK_MOD_OPERANDS(F));
  return r;
}

// a + b < 2p < 2^255: no carry out of the top word.
template <int F>
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t t[8];
  asm(
    "add.cc.u32 %0, %8, %16;\n\t"
    "addc.cc.u32 %1, %9, %17;\n\t"
    "addc.cc.u32 %2, %10, %18;\n\t"
    "addc.cc.u32 %3, %11, %19;\n\t"
    "addc.cc.u32 %4, %12, %20;\n\t"
    "addc.cc.u32 %5, %13, %21;\n\t"
    "addc.cc.u32 %6, %14, %22;\n\t"
    "addc.u32 %7, %15, %23;\n\t"
    : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]), "=r"(t[5]), "=r"(t[6]), "=r"(t[7])
    : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
  return fe_mont_reduce<F>(t);
}

// a - b, plus p where it borrows.
template <int F>
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
  asm(
    "{\n\t"
    ".reg .u32 zk_q0, zk_q1, zk_q2, zk_q3, zk_q4, zk_q5, zk_q6, zk_q7, zk_bw, zk_zero;\n\t"
    "mov.u32 zk_zero, 0;\n\t"
    "sub.cc.u32 %0, %8, %16;\n\t"
    "subc.cc.u32 %1, %9, %17;\n\t"
    "subc.cc.u32 %2, %10, %18;\n\t"
    "subc.cc.u32 %3, %11, %19;\n\t"
    "subc.cc.u32 %4, %12, %20;\n\t"
    "subc.cc.u32 %5, %13, %21;\n\t"
    "subc.cc.u32 %6, %14, %22;\n\t"
    "subc.cc.u32 %7, %15, %23;\n\t"
    "subc.u32 zk_bw, zk_zero, zk_zero;\n\t"
    "and.b32 zk_q0, zk_bw, %24;\n\t"
    "and.b32 zk_q1, zk_bw, %25;\n\t"
    "and.b32 zk_q2, zk_bw, %26;\n\t"
    "and.b32 zk_q3, zk_bw, %27;\n\t"
    "and.b32 zk_q4, zk_bw, %28;\n\t"
    "and.b32 zk_q5, zk_bw, %29;\n\t"
    "and.b32 zk_q6, zk_bw, %30;\n\t"
    "and.b32 zk_q7, zk_bw, %31;\n\t"
    "add.cc.u32 %0, %0, zk_q0;\n\t"
    "addc.cc.u32 %1, %1, zk_q1;\n\t"
    "addc.cc.u32 %2, %2, zk_q2;\n\t"
    "addc.cc.u32 %3, %3, zk_q3;\n\t"
    "addc.cc.u32 %4, %4, zk_q4;\n\t"
    "addc.cc.u32 %5, %5, zk_q5;\n\t"
    "addc.cc.u32 %6, %6, zk_q6;\n\t"
    "addc.u32 %7, %7, zk_q7;\n\t"
    "}\n\t"
    : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]), "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7])
    : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]), ZK_MOD_OPERANDS(F));
  return r;
}

template <int F>
__device__ __forceinline__ Fe fe_neg(const Fe& a) {
  return fe_sub<F>(fe_zero(), a);
}

// Montgomery product a b / 2^256 mod p of canonical a, b: row i adds
// a * b_i and then m p and drops the zero low word. t < 2p between rows and
// t + a b_i + m p < 2^288, so no carry leaves t_8.
template <int F>
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    fe_mont_row(t, a, b.w[i]);
    fe_mont_redc<F>(t);
#pragma unroll
    for (int j = 0; j < 8; j++) t[j] = t[j + 1];
    t[8] = 0;
  }
  return fe_mont_reduce<F>(t);
}

// The same product as a function of its own, not inlined: where a hot loop
// holds many products, inlined copies (~530 instructions each) can make it
// outgrow the instruction cache, and one shared copy stays in it.
template <int F>
__device__ __noinline__ Fe fe_mul_call(Fe a, Fe b) {
  return fe_mul<F>(a, b);
}

template <int F>
__device__ __forceinline__ Fe fe_sqr(const Fe& a) {
  return fe_mul<F>(a, a);
}

template <int F>
__device__ __forceinline__ Fe fe_double(const Fe& a) {
  return fe_add<F>(a, a);
}

}  // namespace zk
