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
// Fq arithmetic is field.cuh's PTX carry chains, through struct Ptx, the
// one interface (mul, add, sub) the formulas are written against. The
// product is a function of its own, not inlined (Ptx::mul says why).
#pragma once

#include "field.cuh"

namespace zk {

struct Ptx {
  // Not inlined: a point formula holds 7 to 16 products, and inlined
  // copies (~530 instructions each) make a kernel's hot loop outgrow the
  // instruction cache; one shared copy stays in it.
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) { return fe_mul_call<FQ>(a, b); }
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
