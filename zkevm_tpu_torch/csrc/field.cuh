// BN254 Fr / Fq arithmetic on 8 x 32-bit little-endian words, Montgomery
// form with R = 2^256, always canonical (< p). Device functions shared by
// the field, NTT and curve kernels.
//
// Multiplication is CIOS with 64-bit accumulators: per word of b, a*b_i is
// added into t and one Montgomery step m*p clears the low word. Every
// product (2^32-1)^2 plus two words fits in 64 bits. p < 2^254, so sums
// of two canonical values never carry out of 256 bits and one conditional
// subtraction canonicalises every result.
#pragma once

#include "common.cuh"

namespace zk {

enum FieldId { FR = 0, FQ = 1 };

static __constant__ uint32_t kModulus[2][8] = {
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u},
};
// R mod p: 1 in Montgomery form.
static __constant__ uint32_t kMontOne[2][8] = {
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, 0x7879462eu,
     0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu,
     0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
};
// -p^{-1} mod 2^32.
static __constant__ uint32_t kNInv[2] = {0xefffffffu, 0xe4866389u};

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

// t -= p if t >= p (t < 2p).
template <int F>
__device__ __forceinline__ void fe_reduce_once(Fe& t) {
  uint32_t d[8];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = (uint64_t)t.w[i] - kModulus[F][i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint32_t keep_d = borrow - 1u;  // all ones when t >= p
#pragma unroll
  for (int i = 0; i < 8; i++) t.w[i] = (d[i] & keep_d) | (t.w[i] & ~keep_d);
}

template <int F>
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = (uint64_t)a.w[i] + b.w[i] + c;
    r.w[i] = (uint32_t)s;
    c = s >> 32;
  }
  fe_reduce_once<F>(r);
  return r;
}

template <int F>
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = (uint64_t)a.w[i] - b.w[i] - borrow;
    r.w[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint32_t add_p = 0u - borrow;  // all ones when a < b
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = (uint64_t)r.w[i] + (kModulus[F][i] & add_p) + c;
    r.w[i] = (uint32_t)s;
    c = s >> 32;
  }
  return r;
}

template <int F>
__device__ __forceinline__ Fe fe_neg(const Fe& a) {
  return fe_sub<F>(fe_zero(), a);
}

template <int F>
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * kNInv[F];
    s = (uint64_t)m * kModulus[F][0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)m * kModulus[F][j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = t[i];
  fe_reduce_once<F>(r);
  return r;
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
