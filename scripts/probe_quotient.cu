// Product-rate probe for scripts/probe_quotient.py: the sustained rate of
// one BN254 Fr Montgomery product in registers, in three forms, on the same
// inputs (their words must agree):
//   0  the 64-bit-accumulator CIOS product that field.cuh held before its
//      PTX carry chains (a copy kept here, so the comparison still runs);
//   1  field.cuh's fe_mul<FR>, the PTX carry chains, inlined;
//   2  field.cuh's fe_mul_call<FR>, the same product as a called function.
// Each thread runs two independent chains x <- x c, z <- z c of `steps`
// products each, so the issue slots see two products at a time, and the
// grid holds many more threads than the card keeps resident.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC -Xptxas -v -I zkevm_tpu_torch/csrc -o lib.so this file

#include "field.cuh"

using namespace zk;

namespace {

__constant__ uint32_t kFr[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                                0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
constexpr uint32_t kFrNInv = 0xefffffffu;

// t -= p if t >= p (t < 2p).
__device__ __forceinline__ void cios_reduce_once(Fe& t) {
  uint32_t d[8];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = (uint64_t)t.w[i] - kFr[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  uint32_t keep_d = borrow - 1u;  // all ones when t >= p
#pragma unroll
  for (int i = 0; i < 8; i++) t.w[i] = (d[i] & keep_d) | (t.w[i] & ~keep_d);
}

// CIOS with 64-bit accumulators: per word of b, a*b_i is added into t and
// one Montgomery step m*p clears the low word.
__device__ __forceinline__ Fe cios_mul(const Fe& a, const Fe& b) {
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
    uint32_t m = t[0] * kFrNInv;
    s = (uint64_t)m * kFr[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)m * kFr[j] + t[j] + c;
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
  cios_reduce_once(r);
  return r;
}

template <int FORM>
__device__ __forceinline__ Fe product(const Fe& a, const Fe& b) {
  if (FORM == 0) return cios_mul(a, b);
  if (FORM == 1) return fe_mul<FR>(a, b);
  return fe_mul_call<FR>(a, b);
}

// in: (threads, 3, 8) x, z, c; out: (threads, 2, 8) x, z after the chains.
template <int FORM>
__global__ void __launch_bounds__(256) chain_kernel(uint32_t* __restrict__ out,
                                                    const uint32_t* __restrict__ in, i64 threads,
                                                    int steps) {
  const i64 t = blockIdx.x * (i64)blockDim.x + threadIdx.x;
  if (t >= threads) return;
  Fe x = fe_load(in + 24 * t), z = fe_load(in + 24 * t + 8);
  const Fe c = fe_load(in + 24 * t + 16);
  for (int i = 0; i < steps; i++) {
    x = product<FORM>(x, c);
    z = product<FORM>(z, c);
  }
  fe_store(out + 16 * t, x);
  fe_store(out + 16 * t + 8, z);
}

}  // namespace

ZK_EXPORT int zk_probe_chain(void* out, const void* in, i64 threads, i64 steps, i64 form,
                             void* stream) {
  if (threads < 1 || steps < 0 || form < 0 || form > 2) return (int)cudaErrorInvalidValue;
  const int blocks = zk_blocks(threads, 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 0)
    chain_kernel<0><<<blocks, 256, 0, s>>>((uint32_t*)out, (const uint32_t*)in, threads, (int)steps);
  else if (form == 1)
    chain_kernel<1><<<blocks, 256, 0, s>>>((uint32_t*)out, (const uint32_t*)in, threads, (int)steps);
  else
    chain_kernel<2><<<blocks, 256, 0, s>>>((uint32_t*)out, (const uint32_t*)in, threads, (int)steps);
  return (int)cudaGetLastError();
}
