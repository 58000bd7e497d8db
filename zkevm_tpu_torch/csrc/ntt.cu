// Kernel B: radix-2 NTT over BN254 Fr on a batch of columns.
//
// Replaces zkevm_tpu/poly/ntt.py::_fft_core (via ntt / intt): an in-order
// to in-order decimation-in-time transform, a bit-reversal gather followed
// by log2(n) butterfly stages with twiddles w^(j * n/m). Inverse scaling
// (1/n) and coset shifts are Montgomery products done by kernel A.
//
// Bound on the H100: a stage reads and writes every element once (64 bytes)
// and does one Montgomery product per butterfly (~132 multiply instructions
// per element), so each pass through device memory is close to balanced
// between bytes and int32 multiplies. Design: the first log2(T) stages act
// on contiguous tiles of T = 2^10 elements after the bit reversal, so one
// launch runs them all in shared memory (one pass over device memory
// instead of ten); each later stage is one launch with one thread per
// butterfly. Columns of the batch are independent, so tiles and butterflies
// never straddle two columns.

#include "field.cuh"

using namespace zk;

namespace {

__device__ __forceinline__ void copy_elem(uint32_t* dst, const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = s[0];
  d[1] = s[1];
}

__global__ void bitrev_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ in, int k,
                              i64 total) {
  const i64 mask = (1LL << k) - 1;
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < total;
       i += (i64)gridDim.x * blockDim.x) {
    i64 col = i >> k;
    uint32_t j = (uint32_t)(i & mask);
    uint32_t r = __brev(j) >> (32 - k);
    copy_elem(out + 8 * ((col << k) + r), in + 8 * i);
  }
}

__device__ __forceinline__ void butterfly(Fe& x0, Fe& x1, const Fe& w) {
  Fe t = fe_mul<FR>(w, x1);
  Fe y0 = fe_add<FR>(x0, t);
  x1 = fe_sub<FR>(x0, t);
  x0 = y0;
}

// Stages 1..logt on tiles of 2^logt contiguous elements.
__global__ void shared_stages_kernel(uint32_t* __restrict__ data, const uint32_t* __restrict__ tw,
                                     int k, int logt) {
  extern __shared__ uint4 sh_raw[];  // 16-byte aligned for vector access
  uint32_t* sh = reinterpret_cast<uint32_t*>(sh_raw);
  const int T = 1 << logt;
  uint32_t* tile = data + 8 * ((i64)blockIdx.x << logt);
  for (int e = threadIdx.x; e < T; e += blockDim.x) copy_elem(sh + 8 * e, tile + 8 * e);
  __syncthreads();
  for (int s = 1; s <= logt; s++) {
    const int half = 1 << (s - 1);
    for (int t = threadIdx.x; t < T / 2; t += blockDim.x) {
      int grp = t >> (s - 1);
      int j = t & (half - 1);
      int i0 = (grp << s) + j;
      int i1 = i0 + half;
      Fe w = fe_load(tw + 8 * ((i64)j << (k - s)));
      Fe x0 = fe_load(sh + 8 * i0);
      Fe x1 = fe_load(sh + 8 * i1);
      butterfly(x0, x1, w);
      fe_store(sh + 8 * i0, x0);
      fe_store(sh + 8 * i1, x1);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < T; e += blockDim.x) copy_elem(tile + 8 * e, sh + 8 * e);
}

// One stage s (> logt) over all columns: one thread per butterfly.
__global__ void stage_kernel(uint32_t* __restrict__ data, const uint32_t* __restrict__ tw, int k,
                             int s, i64 total_bfly) {
  const i64 half_n_mask = (1LL << (k - 1)) - 1;
  const i64 half = 1LL << (s - 1);
  for (i64 t = blockIdx.x * (i64)blockDim.x + threadIdx.x; t < total_bfly;
       t += (i64)gridDim.x * blockDim.x) {
    i64 col = t >> (k - 1);
    i64 u = t & half_n_mask;
    i64 grp = u >> (s - 1);
    i64 j = u & (half - 1);
    i64 i0 = (col << k) + (grp << s) + j;
    i64 i1 = i0 + half;
    Fe w = fe_load(tw + 8 * (j << (k - s)));
    Fe x0 = fe_load(data + 8 * i0);
    Fe x1 = fe_load(data + 8 * i1);
    butterfly(x0, x1, w);
    fe_store(data + 8 * i0, x0);
    fe_store(data + 8 * i1, x1);
  }
}

}  // namespace

ZK_EXPORT int zk_ntt_bitrev(void* out, const void* in, i64 k, i64 batch, void* stream) {
  if (k < 1 || k > 30) return (int)cudaErrorInvalidValue;
  i64 total = batch << k;
  if (total == 0) return 0;
  bitrev_kernel<<<zk_blocks(total, 256), 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, (int)k, total);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_ntt_shared(void* data, const void* tw, i64 k, i64 logt, i64 batch, void* stream) {
  if (logt < 1 || logt > 10 || logt > k) return (int)cudaErrorInvalidValue;
  i64 tiles = batch << (k - logt);
  if (tiles == 0) return 0;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)32 << logt;
  shared_stages_kernel<<<(unsigned)tiles, 256, smem, (cudaStream_t)stream>>>(
      (uint32_t*)data, (const uint32_t*)tw, (int)k, (int)logt);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_ntt_stage(void* data, const void* tw, i64 k, i64 s, i64 batch, void* stream) {
  if (s < 1 || s > k || k > 30) return (int)cudaErrorInvalidValue;
  i64 total = batch << (k - 1);
  if (total == 0) return 0;
  stage_kernel<<<zk_blocks(total, 256), 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)data, (const uint32_t*)tw, (int)k, (int)s, total);
  return (int)cudaGetLastError();
}
