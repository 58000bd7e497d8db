// BN254 G1 point arithmetic over Fq, shared by the curve (C) and Pippenger
// (G) kernels, and the Fq arithmetic they run on.
//
// A point is 24 words: Jacobian x, y, z (8 words each, Montgomery Fq); z = 0
// is the identity. An affine base is 16 words, x and y; (0, 0), which is not
// on the curve, stands for the identity base (group.py ``to_affine`` makes
// it from z = 0). Complete formulas: the identity, doubling and
// opposite-point cases need no special path in the callers, so zero
// scalars, identity bases and repeated bases are right. Every field
// operation returns canonical words, so two ways of computing one formula's
// values give the same words.
//
// Fq arithmetic comes in two forms with one interface (mul, add, sub):
//   Ptx  — PTX carry chains (mad.lo.cc / madc.hi.cc / addc): the Montgomery
//          product is CIOS over 32-bit words with one accumulator, each row
//          a low pass and a high pass, 264 multiply instructions;
//   Cios — field.cuh's 64-bit-accumulator CIOS (fe_mul, fe_add, fe_sub).
// The kernels run on Ptx; the commit MSM also instantiates Cios so that a
// run can time the two on the same work (chip_smoke.py phase 5). In both the
// product is a function of its own, not inlined (Ptx::mul says why).
#pragma once

#include "field.cuh"

namespace zk {

struct Ptx {
  // Each asm statement below holds whole carry chains, so the carry flag is
  // never live between statements and the compiler may interleave the
  // statements of independent products. tests/port/test_torch_affine.py
  // runs this text through a model of its opcodes against integer
  // arithmetic.

  // t += a * bi: the low halves of the word products in one chain, the
  // high halves one word up in a second.
  static __device__ __forceinline__ void row(uint32_t t[9], const Fe& a, uint32_t bi) {
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

  // t += m q with m = t_0 (-q^{-1}) mod 2^32, which clears t_0.
  static __device__ __forceinline__ void redc(uint32_t t[9]) {
    asm(
      "{\n\t"
      ".reg .u32 zk_m;\n\t"
      "mul.lo.u32 zk_m, %0, 0xe4866389;\n\t"
      "mad.lo.cc.u32 %0, zk_m, 0xd87cfd47, %0;\n\t"
      "madc.lo.cc.u32 %1, zk_m, 0x3c208c16, %1;\n\t"
      "madc.lo.cc.u32 %2, zk_m, 0x6871ca8d, %2;\n\t"
      "madc.lo.cc.u32 %3, zk_m, 0x97816a91, %3;\n\t"
      "madc.lo.cc.u32 %4, zk_m, 0x8181585d, %4;\n\t"
      "madc.lo.cc.u32 %5, zk_m, 0xb85045b6, %5;\n\t"
      "madc.lo.cc.u32 %6, zk_m, 0xe131a029, %6;\n\t"
      "madc.lo.cc.u32 %7, zk_m, 0x30644e72, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, zk_m, 0xd87cfd47, %1;\n\t"
      "madc.hi.cc.u32 %2, zk_m, 0x3c208c16, %2;\n\t"
      "madc.hi.cc.u32 %3, zk_m, 0x6871ca8d, %3;\n\t"
      "madc.hi.cc.u32 %4, zk_m, 0x97816a91, %4;\n\t"
      "madc.hi.cc.u32 %5, zk_m, 0x8181585d, %5;\n\t"
      "madc.hi.cc.u32 %6, zk_m, 0xb85045b6, %6;\n\t"
      "madc.hi.cc.u32 %7, zk_m, 0xe131a029, %7;\n\t"
      "madc.hi.u32 %8, zk_m, 0x30644e72, %8;\n\t"
      "}\n\t"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]));
  }

  // t - q if t >= q (t < 2q).
  static __device__ __forceinline__ Fe reduce(const uint32_t t[8]) {
    Fe r;
    asm(
      "{\n\t"
      ".reg .u32 zk_d0, zk_d1, zk_d2, zk_d3, zk_d4, zk_d5, zk_d6, zk_d7, zk_x0, zk_x1, zk_x2, zk_x3, zk_x4, zk_x5, zk_x6, zk_x7, zk_bw, zk_nb, zk_zero;\n\t"
      "mov.u32 zk_zero, 0;\n\t"
      "sub.cc.u32 zk_d0, %8, 0xd87cfd47;\n\t"
      "subc.cc.u32 zk_d1, %9, 0x3c208c16;\n\t"
      "subc.cc.u32 zk_d2, %10, 0x6871ca8d;\n\t"
      "subc.cc.u32 zk_d3, %11, 0x97816a91;\n\t"
      "subc.cc.u32 zk_d4, %12, 0x8181585d;\n\t"
      "subc.cc.u32 zk_d5, %13, 0xb85045b6;\n\t"
      "subc.cc.u32 zk_d6, %14, 0xe131a029;\n\t"
      "subc.cc.u32 zk_d7, %15, 0x30644e72;\n\t"
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
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]), "r"(t[7]));
    return r;
  }

  // Montgomery product a b / 2^256 mod q of canonical a, b: CIOS over
  // 32-bit words, row i adding a * b_i and then m q and dropping the zero
  // low word. t < 2q between rows and t + a b_i + m q < 2^288, so no carry
  // leaves t_8. 264 multiply instructions; one function that every formula
  // calls (see mul below).
  static __device__ __forceinline__ Fe montmul(const Fe& a, const Fe& b) {
    uint32_t t[9];
#pragma unroll
    for (int j = 0; j < 9; j++) t[j] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      row(t, a, b.w[i]);
      redc(t);
#pragma unroll
      for (int j = 0; j < 8; j++) t[j] = t[j + 1];
      t[8] = 0;
    }
    return reduce(t);
  }

  // Not inlined: a point formula holds 7 to 16 products, and inlined
  // copies (~530 instructions each) make a kernel's hot loop outgrow the
  // instruction cache; one shared copy stays in it.
  static __device__ __noinline__ Fe mul(Fe a, Fe b) { return montmul(a, b); }

  // a + b < 2q < 2^255: no carry out of the top word.
  static __device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
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
    return reduce(t);
  }

  // a - b, plus q where it borrows.
  static __device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
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
      "and.b32 zk_q0, zk_bw, 0xd87cfd47;\n\t"
      "and.b32 zk_q1, zk_bw, 0x3c208c16;\n\t"
      "and.b32 zk_q2, zk_bw, 0x6871ca8d;\n\t"
      "and.b32 zk_q3, zk_bw, 0x97816a91;\n\t"
      "and.b32 zk_q4, zk_bw, 0x8181585d;\n\t"
      "and.b32 zk_q5, zk_bw, 0xb85045b6;\n\t"
      "and.b32 zk_q6, zk_bw, 0xe131a029;\n\t"
      "and.b32 zk_q7, zk_bw, 0x30644e72;\n\t"
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
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
    return r;
  }
};

struct Cios {
  static __device__ __noinline__ Fe mul(Fe a, Fe b) { return fe_mul<FQ>(a, b); }
  static __device__ __forceinline__ Fe add(const Fe& a, const Fe& b) { return fe_add<FQ>(a, b); }
  static __device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) { return fe_sub<FQ>(a, b); }
};

template <class F>
__device__ __forceinline__ Fe fq_dbl(const Fe& a) {
  return F::add(a, a);
}

template <class F>
__device__ __forceinline__ Fe fq_neg(const Fe& a) {
  return F::sub(fe_zero(), a);
}

// ---------------------------------------------------------------------------
// Points
// ---------------------------------------------------------------------------

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt pt_load(const uint32_t* p) {
  Pt r;
  r.x = fe_load(p);
  r.y = fe_load(p + 8);
  r.z = fe_load(p + 16);
  return r;
}

__device__ __forceinline__ void pt_store(uint32_t* p, const Pt& a) {
  fe_store(p, a.x);
  fe_store(p + 8, a.y);
  fe_store(p + 16, a.z);
}

__device__ __forceinline__ Pt pt_identity() {
  Pt r;
  r.x = fe_one<FQ>();
  r.y = fe_one<FQ>();
  r.z = fe_zero();
  return r;
}

__device__ __forceinline__ bool pt_is_identity(const Pt& p) { return fe_is_zero(p.z); }

// dbl-2009-l (a = 0); the identity is returned as it is.
template <class F>
__device__ Pt pt_double(const Pt& p) {
  if (pt_is_identity(p)) return p;
  Fe a = F::mul(p.x, p.x);
  Fe b = F::mul(p.y, p.y);
  Fe c = F::mul(b, b);
  Fe xb = F::add(p.x, b);
  Fe d = fq_dbl<F>(F::sub(F::sub(F::mul(xb, xb), a), c));
  Fe e = F::add(fq_dbl<F>(a), a);
  Pt r;
  r.x = F::sub(F::mul(e, e), fq_dbl<F>(d));
  Fe c8 = fq_dbl<F>(fq_dbl<F>(fq_dbl<F>(c)));
  r.y = F::sub(F::mul(e, F::sub(d, r.x)), c8);
  r.z = fq_dbl<F>(F::mul(p.y, p.z));
  return r;
}

// Complete addition: add-2007-bl with the identity, doubling and
// opposite-point cases.
template <class F>
__device__ Pt pt_add(const Pt& p, const Pt& q) {
  if (pt_is_identity(p)) return q;
  if (pt_is_identity(q)) return p;
  Fe z1z1 = F::mul(p.z, p.z);
  Fe z2z2 = F::mul(q.z, q.z);
  Fe u1 = F::mul(p.x, z2z2);
  Fe u2 = F::mul(q.x, z1z1);
  Fe s1 = F::mul(F::mul(p.y, q.z), z2z2);
  Fe s2 = F::mul(F::mul(q.y, p.z), z1z1);
  Fe h = F::sub(u2, u1);
  Fe r = fq_dbl<F>(F::sub(s2, s1));
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) return pt_double<F>(p);
    return pt_identity();
  }
  Fe h2 = fq_dbl<F>(h);
  Fe i = F::mul(h2, h2);
  Fe j = F::mul(h, i);
  Fe v = F::mul(u1, i);
  Pt o;
  o.x = F::sub(F::sub(F::mul(r, r), j), fq_dbl<F>(v));
  o.y = F::sub(F::mul(r, F::sub(v, o.x)), fq_dbl<F>(F::mul(s1, j)));
  Fe zs = F::add(p.z, q.z);
  o.z = F::mul(F::sub(F::sub(F::mul(zs, zs), z1z1), z2z2), h);
  return o;
}

// Complete mixed addition p + (x2, y2): madd-2007-bl (7M + 4S) with the
// identity-base sentinel (0, 0), the identity p, doubling and opposite
// cases. Its X3, Y3, Z3 are the field values pt_add gives for q = (x2, y2, 1)
// (Z3 = (Z1 + H)^2 - Z1Z1 - HH = 2 Z1 H both ways), so the words are equal.
template <class F>
__device__ __forceinline__ Pt pt_madd(const Pt& p, const Fe& x2, const Fe& y2) {
  if (fe_is_zero(x2) && fe_is_zero(y2)) return p;
  if (pt_is_identity(p)) {
    Pt r;
    r.x = x2;
    r.y = y2;
    r.z = fe_one<FQ>();
    return r;
  }
  Fe z1z1 = F::mul(p.z, p.z);
  Fe u2 = F::mul(x2, z1z1);
  Fe s2 = F::mul(y2, F::mul(p.z, z1z1));
  Fe h = F::sub(u2, p.x);
  Fe r = fq_dbl<F>(F::sub(s2, p.y));
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) return pt_double<F>(p);
    return pt_identity();
  }
  Fe hh = F::mul(h, h);
  Fe i = fq_dbl<F>(fq_dbl<F>(hh));
  Fe j = F::mul(h, i);
  Fe v = F::mul(p.x, i);
  Pt o;
  o.x = F::sub(F::sub(F::mul(r, r), j), fq_dbl<F>(v));
  o.y = F::sub(F::mul(r, F::sub(v, o.x)), fq_dbl<F>(F::mul(p.y, j)));
  Fe zh = F::add(p.z, h);
  o.z = F::sub(F::sub(F::mul(zh, zh), z1z1), hh);
  return o;
}

// ---------------------------------------------------------------------------
// Warp-cooperative formulas for serial chains (Horner). All 32 lanes call
// them with the same operands; each lane computes one of the formula's
// independent products and the others read it by shuffle, so a doubling
// waits on 3 products in sequence instead of 7 and an addition on 5 instead
// of 16. The values, and so the words, are pt_double's and pt_add's.
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fe fe_shfl(const Fe& a, int src) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = __shfl_sync(0xffffffffu, a.w[k], src);
  return r;
}

__device__ __forceinline__ Fe fe_pick(int lane, const Fe& a0, const Fe& a1, const Fe& a2) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = lane == 0 ? a0.w[k] : (lane == 1 ? a1.w[k] : a2.w[k]);
  return r;
}

__device__ __forceinline__ Fe fe_pick5(int lane, const Fe& a0, const Fe& a1, const Fe& a2,
                                       const Fe& a3, const Fe& a4) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++)
    r.w[k] = lane == 0 ? a0.w[k]
           : lane == 1 ? a1.w[k]
           : lane == 2 ? a2.w[k]
           : lane == 3 ? a3.w[k]
                       : a4.w[k];
  return r;
}

template <class F>
__device__ Pt pt_double_warp(const Pt& p) {
  if (pt_is_identity(p)) return p;
  const int lane = threadIdx.x & 31;
  // a = x^2, b = y^2, yz = y z
  Fe prod = F::mul(fe_pick(lane, p.x, p.y, p.y), fe_pick(lane, p.x, p.y, p.z));
  const Fe a = fe_shfl(prod, 0), b = fe_shfl(prod, 1), yz = fe_shfl(prod, 2);
  // c = b^2, (x + b)^2, f = e^2 with e = 3a
  const Fe e = F::add(fq_dbl<F>(a), a);
  const Fe sq = fe_pick(lane, b, F::add(p.x, b), e);
  prod = F::mul(sq, sq);
  const Fe c = fe_shfl(prod, 0), xb2 = fe_shfl(prod, 1), f = fe_shfl(prod, 2);
  const Fe d = fq_dbl<F>(F::sub(F::sub(xb2, a), c));
  Pt r;
  r.x = F::sub(f, fq_dbl<F>(d));
  const Fe c8 = fq_dbl<F>(fq_dbl<F>(fq_dbl<F>(c)));
  r.y = F::sub(F::mul(e, F::sub(d, r.x)), c8);
  r.z = fq_dbl<F>(yz);
  return r;
}

template <class F>
__device__ Pt pt_add_warp(const Pt& p, const Pt& q) {
  if (pt_is_identity(p)) return q;
  if (pt_is_identity(q)) return p;
  const int lane = threadIdx.x & 31;
  // z1z1, z2z2, y1 z2, y2 z1, (z1 + z2)^2
  const Fe zs = F::add(p.z, q.z);
  Fe prod = F::mul(fe_pick5(lane, p.z, q.z, p.y, q.y, zs), fe_pick5(lane, p.z, q.z, q.z, p.z, zs));
  const Fe z1z1 = fe_shfl(prod, 0), z2z2 = fe_shfl(prod, 1), t1 = fe_shfl(prod, 2);
  const Fe t2 = fe_shfl(prod, 3), zz = fe_shfl(prod, 4);
  // u1 = x1 z2z2, u2 = x2 z1z1, s1 = t1 z2z2, s2 = t2 z1z1
  Fe lhs;
  Fe rhs;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    lhs.w[k] = lane == 0 ? p.x.w[k] : lane == 1 ? q.x.w[k] : lane == 2 ? t1.w[k] : t2.w[k];
    rhs.w[k] = (lane & 1) ? z1z1.w[k] : z2z2.w[k];
  }
  prod = F::mul(lhs, rhs);
  const Fe u1 = fe_shfl(prod, 0), u2 = fe_shfl(prod, 1), s1 = fe_shfl(prod, 2), s2 = fe_shfl(prod, 3);
  const Fe h = F::sub(u2, u1);
  const Fe r = fq_dbl<F>(F::sub(s2, s1));
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) return pt_double_warp<F>(p);
    return pt_identity();
  }
  // i = (2h)^2, r^2, z3 = (zz - z1z1 - z2z2) h
  const Fe h2 = fq_dbl<F>(h);
  const Fe zd = F::sub(F::sub(zz, z1z1), z2z2);
  prod = F::mul(fe_pick(lane, h2, r, zd), fe_pick(lane, h2, r, h));
  const Fe i = fe_shfl(prod, 0), rr = fe_shfl(prod, 1), z3 = fe_shfl(prod, 2);
  // j = h i, v = u1 i
  prod = F::mul(fe_pick(lane, h, u1, u1), i);
  const Fe j = fe_shfl(prod, 0), v = fe_shfl(prod, 1);
  Pt o;
  o.x = F::sub(F::sub(rr, j), fq_dbl<F>(v));
  // r (v - x3), s1 j
  prod = F::mul(fe_pick(lane, r, s1, s1), fe_pick(lane, F::sub(v, o.x), j, j));
  const Fe m1 = fe_shfl(prod, 0), m2 = fe_shfl(prod, 1);
  o.y = F::sub(m1, fq_dbl<F>(m2));
  o.z = z3;
  return o;
}

}  // namespace zk
