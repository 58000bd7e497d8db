// Kernel A: elementwise BN254 Fr / Fq field arithmetic.
//
// Replaces the TPU limb kernels of zkevm_tpu/ff/limbs.py: mont_mul (CIOS
// on (..., 16) 16-bit limbs; sqr, to_mont and from_mont are mont_mul by a
// constant), add / sub / neg (conditional subtract), pow_const and inv
// (square-and-multiply, inv(0) = 0).
//
// Bound on the H100: one Montgomery product reads 64 bytes and writes 32
// while it issues ~264 32-bit multiply(-add) instructions, so mont_mul sits
// near the balance point of the card's memory rate and its int32 rate;
// add / sub are bound by bytes and pow (hundreds of products per element)
// by multiplies. Design: one thread per element, 8 words moved as two
// 16-byte vector loads, all limb loops unrolled into registers, broadcast
// operands read through stride-0 indexing instead of being materialised.
// Carry chains use 64-bit accumulators; PTX add-with-carry is later work.
//
// Kernel F (zk_field_nonzero): the MockProver's per-row zero test. It
// replaces the device part of zkevm_tpu/plonk/mock.py MockProver.verify
// after the gate evaluation (ff.is_zero over (m, [W,] 16) limbs, read back
// whole): it folds each 8-word element into one byte, 1 where the element
// is not zero, so the host reads back m (or m * W) flags instead of 32
// bytes each. Bound by bytes: 32 read and 1 written per element. One
// thread per element, two 16-byte loads.

#include "field.cuh"

using namespace zk;

namespace {

enum Op { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_NEG = 3 };

// Output shape (d0, d1, d2, d3) in elements; a and b address their element
// (i0, i1, i2, i3) at i0*s0 + i1*s1 + i2*s2 + i3*s3 elements (stride 0 on
// broadcast dimensions).
struct Layout {
  i64 d1, d2, d3;
  i64 as0, as1, as2, as3;
  i64 bs0, bs1, bs2, bs3;
};

template <int F, int OP>
__global__ void binary_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b, Layout L, i64 n) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    i64 r = i;
    i64 i3 = r % L.d3;
    r /= L.d3;
    i64 i2 = r % L.d2;
    r /= L.d2;
    i64 i1 = r % L.d1;
    i64 i0 = r / L.d1;
    Fe x = fe_load(a + 8 * (i0 * L.as0 + i1 * L.as1 + i2 * L.as2 + i3 * L.as3));
    Fe z;
    if (OP == OP_NEG) {
      z = fe_neg<F>(x);
    } else {
      Fe y = fe_load(b + 8 * (i0 * L.bs0 + i1 * L.bs1 + i2 * L.bs2 + i3 * L.bs3));
      if (OP == OP_ADD) z = fe_add<F>(x, y);
      if (OP == OP_SUB) z = fe_sub<F>(x, y);
      if (OP == OP_MUL) z = fe_mul<F>(x, y);
    }
    fe_store(out + 8 * i, z);
  }
}

struct Exponent {
  uint32_t w[8];
  int nbits;
};

// out[i] = a[i]^e, MSB-first square-and-multiply from 1. The exponent is
// the same for every thread, so the branch never diverges.
template <int F>
__global__ void pow_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                           Exponent e, i64 n) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    Fe base = fe_load(a + 8 * i);
    Fe acc = fe_one<F>();
    for (int bit = e.nbits - 1; bit >= 0; bit--) {
      acc = fe_sqr<F>(acc);
      if ((e.w[bit >> 5] >> (bit & 31)) & 1u) acc = fe_mul<F>(acc, base);
    }
    fe_store(out + 8 * i, acc);
  }
}

template <int F>
void launch_binary(int op, uint32_t* out, const uint32_t* a, const uint32_t* b, const Layout& L,
                   i64 n, cudaStream_t s) {
  const int threads = 256;
  int blocks = zk_blocks(n, threads);
  switch (op) {
    case OP_ADD: binary_kernel<F, OP_ADD><<<blocks, threads, 0, s>>>(out, a, b, L, n); break;
    case OP_SUB: binary_kernel<F, OP_SUB><<<blocks, threads, 0, s>>>(out, a, b, L, n); break;
    case OP_MUL: binary_kernel<F, OP_MUL><<<blocks, threads, 0, s>>>(out, a, b, L, n); break;
    case OP_NEG: binary_kernel<F, OP_NEG><<<blocks, threads, 0, s>>>(out, a, b, L, n); break;
  }
}

__global__ void nonzero_kernel(uint8_t* __restrict__ out, const uint32_t* __restrict__ a, i64 n) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    out[i] = fe_is_zero(fe_load(a + 8 * i)) ? 0 : 1;
  }
}

}  // namespace

// meta: d0, d1, d2, d3, as0..as3, bs0..bs3 (12 values, host memory).
ZK_EXPORT int zk_field_binary(i64 field, i64 op, void* out, const void* a, const void* b,
                              const i64* meta, i64 n, void* stream) {
  if (n == 0) return 0;
  if (field < 0 || field > 1 || op < 0 || op > 3) return (int)cudaErrorInvalidValue;
  Layout L{meta[1], meta[2], meta[3], meta[4], meta[5], meta[6], meta[7],
           meta[8], meta[9], meta[10], meta[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (field == FR)
    launch_binary<FR>((int)op, (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, L, n, s);
  else
    launch_binary<FQ>((int)op, (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, L, n, s);
  return (int)cudaGetLastError();
}

// exp: 8 little-endian words of the exponent (host memory).
ZK_EXPORT int zk_field_pow(i64 field, void* out, const void* a, const uint32_t* exp, i64 nbits,
                           i64 n, void* stream) {
  if (n == 0) return 0;
  if (field < 0 || field > 1 || nbits < 0 || nbits > 256) return (int)cudaErrorInvalidValue;
  Exponent e;
  for (int i = 0; i < 8; i++) e.w[i] = exp[i];
  e.nbits = (int)nbits;
  const int threads = 256;
  int blocks = zk_blocks(n, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == FR)
    pow_kernel<FR><<<blocks, threads, 0, s>>>((uint32_t*)out, (const uint32_t*)a, e, n);
  else
    pow_kernel<FQ><<<blocks, threads, 0, s>>>((uint32_t*)out, (const uint32_t*)a, e, n);
  return (int)cudaGetLastError();
}

// a: n elements of 8 words; out: n bytes (1 = not zero).
ZK_EXPORT int zk_field_nonzero(void* out, const void* a, i64 n, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  nonzero_kernel<<<zk_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)out, (const uint32_t*)a, n);
  return (int)cudaGetLastError();
}
