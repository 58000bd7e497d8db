// Kernel J: the lazy 13-bit-limb field, elementwise over limbs-first
// (21, n) arrays (int32 words read as u32).
//
// Replaces the TPU kernels of zkevm_tpu/ff/lazy13.py: mul13, sqr13 (441 /
// 231 u32 limb products and one constant u8 matmul for the reduction, on
// the MXU there), combine_reduce (signed scales folded into the matrix),
// add13 / sub13, canon13 / is_zero13 (Barrett step, ripple, conditional
// subtractions), prod_T / sqr_T and the layout conversions from_u16_t /
// to_u16_t (here from / to the port's (n, 8) words). The device functions
// are in lazy13.cuh; kernel L (msm13.cu) runs the same functions inside its
// point formulas. These entry points serve the comparisons with the plain
// version and the kernel's own timing.
//
// Bound on the H100: a product issues 441 32-bit multiplies (16.7 T/s) and
// 42 x 164 u8 MACs on the tensor cores (1,979 T/s) per element and moves
// 84 bytes in, 84 out, so the multiplies bound it; add / sub / the
// conversions are bound by bytes. Design: one element per thread, 4 warps
// per block, each warp with 6.6 KB of shared memory to exchange its 32
// elements' product columns and accumulators with the tensor cores.

#include "lazy13.cuh"

using namespace l13;

namespace {

constexpr int THREADS = 128;

enum BinOp { OP_MUL = 0, OP_SQR = 1, OP_ADD = 2, OP_SUB = 3 };

__global__ void __launch_bounds__(THREADS) k_binary(const __grid_constant__ Field F, const uint4* __restrict__ mat, int op,
                                                    uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                                                    const uint32_t* __restrict__ b, i64 n) {
  __shared__ uint32_t smem[THREADS / 32 * SLOT_WORDS];
  const Warp w{smem + (threadIdx.x >> 5) * SLOT_WORDS, static_cast<int>(threadIdx.x & 31)};
  const i64 i = static_cast<i64>(blockIdx.x) * THREADS + threadIdx.x;
  const i64 ic = i < n ? i : n - 1;  // lanes past n compute on the last element (warp-collective MMA)
  uint32_t x[L], y[L], r[L];
  load13(x, a, ic, n);
  load13(y, b, ic, n);
  if (op == OP_MUL || op == OP_SQR) {
    Acc A;
    acc_zero(A);
    if (op == OP_MUL)
      term_prod(A, w, x, y, mat);
    else
      term_sqr(A, w, x, mat);
    acc_finish(F, A, w, r);
  } else if (op == OP_ADD) {
    add13(F, x, y, r);
  } else {
    sub13(F, x, y, r);
  }
  if (i < n) store13(out, r, i, n);
}

struct Terms {
  const uint32_t* t[4];  // (41, n) product columns
  const uint4* m[4];     // their scaled matrices
};

__global__ void __launch_bounds__(THREADS) k_combine(const __grid_constant__ Field F, uint32_t* __restrict__ out, const Terms terms,
                                                     int nterms, i64 n) {
  __shared__ uint32_t smem[THREADS / 32 * SLOT_WORDS];
  const Warp w{smem + (threadIdx.x >> 5) * SLOT_WORDS, static_cast<int>(threadIdx.x & 31)};
  const i64 i = static_cast<i64>(blockIdx.x) * THREADS + threadIdx.x;
  const i64 ic = i < n ? i : n - 1;
  Acc A;
  acc_zero(A);
  for (int k = 0; k < nterms; ++k) {
    uint32_t T[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) T[j] = terms.t[k][j * n + ic];
    acc_T(A, w, T, terms.m[k]);
  }
  uint32_t r[L];
  acc_finish(F, A, w, r);
  if (i < n) store13(out, r, i, n);
}

__global__ void k_prod_T(uint32_t* __restrict__ out, const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                         int square, i64 n) {
  const i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L], T[NP];
  load13(x, a, i, n);
  if (square) {
    sqr_T(x, T);
  } else {
    uint32_t y[L];
    load13(y, b, i, n);
    prod_T(x, y, T);
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) out[j * n + i] = T[j];
}

__global__ void k_canon(const __grid_constant__ Field F, uint32_t* __restrict__ out, const uint32_t* __restrict__ a, i64 n) {
  const i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L], r[L];
  load13(x, a, i, n);
  canon13(F, x, r);
  store13(out, r, i, n);
}

__global__ void k_is_zero(const __grid_constant__ Field F, uint8_t* __restrict__ out, const uint32_t* __restrict__ a, i64 n) {
  const i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L];
  load13(x, a, i, n);
  out[i] = is_zero13(F, x) ? 1 : 0;
}

// (n, 8) standard-form words -> (21, n) strict limbs (bits >= 256 are zero)
__global__ void k_from_words(uint32_t* __restrict__ out, const uint32_t* __restrict__ words, i64 n) {
  const i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = words[i * 8 + j];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int j = (13 * l) / 32, off = (13 * l) % 32;
    uint32_t v = 0u;
    if (j < 8) {
      v = w[j] >> off;
      if (off + 13 > 32 && j + 1 < 8) v |= w[j + 1] << (32 - off);
    }
    out[l * n + i] = v & M13;
  }
}

// (21, n) strict limbs -> (n, 8) words of the value mod 2^256
__global__ void k_to_words(uint32_t* __restrict__ out, const uint32_t* __restrict__ a, i64 n) {
  const i64 i = static_cast<i64>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[L];
  load13(x, a, i, n);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t v = 0u;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int shift = 13 * l - 32 * j;
      if (shift >= 0 && shift < 32) v |= x[l] << shift;
      if (shift < 0 && shift > -13) v |= x[l] >> (-shift);
    }
    out[i * 8 + j] = v;
  }
}

}  // namespace

ZK_EXPORT int zk_l13_binary(const Field* field, const uint4* mat, i64 op, uint32_t* out, const uint32_t* a,
                            const uint32_t* b, i64 n, cudaStream_t stream) {
  k_binary<<<zk_blocks(n, THREADS), THREADS, 0, stream>>>(*field, mat, static_cast<int>(op), out, a, b, n);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_l13_combine(const Field* field, uint32_t* out, const unsigned long long* ptrs, i64 nterms, i64 n,
                             cudaStream_t stream) {
  Terms terms{};
  for (int k = 0; k < nterms && k < 4; ++k) {
    terms.t[k] = reinterpret_cast<const uint32_t*>(ptrs[k]);
    terms.m[k] = reinterpret_cast<const uint4*>(ptrs[4 + k]);
  }
  k_combine<<<zk_blocks(n, THREADS), THREADS, 0, stream>>>(*field, out, terms, static_cast<int>(nterms), n);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_l13_prod_T(uint32_t* out, const uint32_t* a, const uint32_t* b, i64 square, i64 n,
                            cudaStream_t stream) {
  k_prod_T<<<zk_blocks(n, THREADS), THREADS, 0, stream>>>(out, a, b, static_cast<int>(square), n);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_l13_canon(const Field* field, uint32_t* out, const uint32_t* a, i64 n, cudaStream_t stream) {
  k_canon<<<zk_blocks(n, THREADS), THREADS, 0, stream>>>(*field, out, a, n);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_l13_is_zero(const Field* field, uint8_t* out, const uint32_t* a, i64 n, cudaStream_t stream) {
  k_is_zero<<<zk_blocks(n, THREADS), THREADS, 0, stream>>>(*field, out, a, n);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_l13_from_words(uint32_t* out, const uint32_t* words, i64 n, cudaStream_t stream) {
  k_from_words<<<zk_blocks(n, THREADS), THREADS, 0, stream>>>(out, words, n);
  return static_cast<int>(cudaGetLastError());
}

ZK_EXPORT int zk_l13_to_words(uint32_t* out, const uint32_t* a, i64 n, cudaStream_t stream) {
  k_to_words<<<zk_blocks(n, THREADS), THREADS, 0, stream>>>(out, a, n);
  return static_cast<int>(cudaGetLastError());
}
