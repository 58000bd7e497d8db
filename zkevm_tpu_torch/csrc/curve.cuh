// BN254 G1 point arithmetic in Jacobian coordinates over Fq, shared by the
// curve (C) and Pippenger (G) kernels. A point is 24 words: x, y, z (8 words
// each, Montgomery Fq); z = 0 is the identity. Complete formulas: the
// identity, doubling and opposite-point cases need no special path in the
// callers, so zero scalars, identity bases and repeated bases are right.
#pragma once

#include "field.cuh"

namespace zk {

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

// dbl-2009-l (a = 0); the identity doubles to the identity (Z3 = 2YZ).
__device__ Pt pt_double(const Pt& p) {
  Fe a = fe_sqr<FQ>(p.x);
  Fe b = fe_sqr<FQ>(p.y);
  Fe c = fe_sqr<FQ>(b);
  Fe d = fe_sqr<FQ>(fe_add<FQ>(p.x, b));
  d = fe_sub<FQ>(fe_sub<FQ>(d, a), c);
  d = fe_double<FQ>(d);
  Fe e = fe_add<FQ>(fe_double<FQ>(a), a);
  Fe f = fe_sqr<FQ>(e);
  Pt r;
  r.x = fe_sub<FQ>(f, fe_double<FQ>(d));
  Fe c8 = fe_double<FQ>(fe_double<FQ>(fe_double<FQ>(c)));
  r.y = fe_sub<FQ>(fe_mul<FQ>(e, fe_sub<FQ>(d, r.x)), c8);
  r.z = fe_double<FQ>(fe_mul<FQ>(p.y, p.z));
  return r;
}

// Complete addition: add-2007-bl with the identity, doubling and
// opposite-point cases.
__device__ Pt pt_add(const Pt& p, const Pt& q) {
  if (pt_is_identity(p)) return q;
  if (pt_is_identity(q)) return p;
  Fe z1z1 = fe_sqr<FQ>(p.z);
  Fe z2z2 = fe_sqr<FQ>(q.z);
  Fe u1 = fe_mul<FQ>(p.x, z2z2);
  Fe u2 = fe_mul<FQ>(q.x, z1z1);
  Fe s1 = fe_mul<FQ>(fe_mul<FQ>(p.y, q.z), z2z2);
  Fe s2 = fe_mul<FQ>(fe_mul<FQ>(q.y, p.z), z1z1);
  Fe h = fe_sub<FQ>(u2, u1);
  Fe r = fe_double<FQ>(fe_sub<FQ>(s2, s1));
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) return pt_double(p);
    return pt_identity();
  }
  Fe i = fe_sqr<FQ>(fe_double<FQ>(h));
  Fe j = fe_mul<FQ>(h, i);
  Fe v = fe_mul<FQ>(u1, i);
  Pt o;
  o.x = fe_sub<FQ>(fe_sub<FQ>(fe_sqr<FQ>(r), j), fe_double<FQ>(v));
  o.y = fe_sub<FQ>(fe_mul<FQ>(r, fe_sub<FQ>(v, o.x)), fe_double<FQ>(fe_mul<FQ>(s1, j)));
  Fe zz = fe_sqr<FQ>(fe_add<FQ>(p.z, q.z));
  o.z = fe_mul<FQ>(fe_sub<FQ>(fe_sub<FQ>(zz, z1z1), z2z2), h);
  return o;
}

// k * p for a small non-negative k (MSB first).
__device__ Pt pt_mul_small(const Pt& p, uint32_t k) {
  Pt acc;
  acc.z = fe_zero();
  acc.x = fe_one<FQ>();
  acc.y = fe_one<FQ>();
  for (int bit = 31; bit >= 0; bit--) {
    acc = pt_double(acc);
    if ((k >> bit) & 1u) acc = pt_add(acc, p);
  }
  return acc;
}

}  // namespace zk
