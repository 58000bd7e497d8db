// Kernel H: the KZG single-point opening's value and quotient.
//
// Replaces the device part of zkevm_tpu/kzg/params.py open_single: the
// barycentric value f(z) = (z^n - 1)/n * sum_i f_i w^i / (z - w^i) and the
// pointwise quotient q_i = (f_i - f(z)) / (w^i - z) over the 2^k domain.
// The wrapper hands in d_i = (w^i - z)^-1 (kernel A's batched Fermat
// inversion, K3) and commits to q through the params' MSM engine.
//
// Three launches:
//   1. terms: each block sums f_i * w^i * d_i over a grid-stride share of
//      the elements and reduces its threads' sums in shared memory to one
//      partial sum per block;
//   2. finish: one block adds the partial sums and multiplies by the
//      constant -(z^n - 1)/n (the sign turns d_i = 1/(w^i - z) into
//      1/(z - w^i)), giving f(z);
//   3. quotient: q_i = (f_i - f(z)) * d_i, one thread per element.
// Field sums are exact, so the block order changes no bit of f(z).
//
// Bound on the H100: per element three Montgomery products (~264 32-bit
// multiply instructions each) against 128 bytes moved (f, w^i and d read,
// q written), so the int32 rate bounds it, near the balance point.

#include "field.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 256;

// The sum of every thread's acc, returned to every thread of the block.
__device__ Fe block_sum(Fe acc) {
  __shared__ Fe sh[kThreads];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = fe_add<FR>(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
  return sh[0];
}

__global__ void __launch_bounds__(kThreads) terms_kernel(uint32_t* __restrict__ partials,
                                                         const uint32_t* __restrict__ f,
                                                         const uint32_t* __restrict__ x,
                                                         const uint32_t* __restrict__ d, i64 n) {
  Fe acc = fe_zero();
  for (i64 i = blockIdx.x * (i64)kThreads + threadIdx.x; i < n; i += (i64)gridDim.x * kThreads) {
    Fe t = fe_mul<FR>(fe_mul<FR>(fe_load(f + 8 * i), fe_load(x + 8 * i)), fe_load(d + 8 * i));
    acc = fe_add<FR>(acc, t);
  }
  Fe total = block_sum(acc);
  if (threadIdx.x == 0) fe_store(partials + 8 * blockIdx.x, total);
}

__global__ void __launch_bounds__(kThreads) finish_kernel(uint32_t* __restrict__ fz,
                                                          const uint32_t* __restrict__ partials,
                                                          i64 m, Fe scale) {
  Fe acc = fe_zero();
  for (i64 i = threadIdx.x; i < m; i += kThreads) acc = fe_add<FR>(acc, fe_load(partials + 8 * i));
  Fe total = block_sum(acc);
  if (threadIdx.x == 0) fe_store(fz, fe_mul<FR>(total, scale));
}

__global__ void quotient_kernel(uint32_t* __restrict__ q, const uint32_t* __restrict__ f,
                                const uint32_t* __restrict__ fz, const uint32_t* __restrict__ d,
                                i64 n) {
  const Fe v = fe_load(fz);
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    fe_store(q + 8 * i, fe_mul<FR>(fe_sub<FR>(fe_load(f + 8 * i), v), fe_load(d + 8 * i)));
  }
}

}  // namespace

// partials: (blocks, 8) words; blocks at most 1024.
ZK_EXPORT int zk_kzg_open_terms(void* partials, const void* f, const void* x, const void* d, i64 n,
                                i64 blocks, void* stream) {
  if (n < 1 || blocks < 1 || blocks > 1024) return (int)cudaErrorInvalidValue;
  terms_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)partials, (const uint32_t*)f, (const uint32_t*)x, (const uint32_t*)d, n);
  return (int)cudaGetLastError();
}

// scale: 8 words of the Montgomery constant (host memory).
ZK_EXPORT int zk_kzg_open_finish(void* fz, const void* partials, i64 m, const uint32_t* scale,
                                 void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  Fe s;
  for (int i = 0; i < 8; i++) s.w[i] = scale[i];
  finish_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>((uint32_t*)fz, (const uint32_t*)partials,
                                                         m, s);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_kzg_open_quotient(void* q, const void* f, const void* fz, const void* d, i64 n,
                                   void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  quotient_kernel<<<zk_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)q, (const uint32_t*)f, (const uint32_t*)fz, (const uint32_t*)d, n);
  return (int)cudaGetLastError();
}
