// Kernel E: the Poseidon permutation over BN254 Fr (P128Pow5T3: t = 3,
// x^5 S-box, 4 full + 56 partial + 4 full rounds, Cauchy MDS), batched.
//
// Replaces the TPU kernel of zkevm_tpu/hash/poseidon.py: permute (three
// lax.scan loops of add / _sbox / _mds_apply over (..., 3, 16) limbs) and
// hash_many (the ConstantLength sponge on top). It computes what that
// kernel computes, not its scan structure:
//
//   zk_poseidon_permute   N states in, N states out;
//   zk_poseidon_trace     all 65 states of each permutation (the input and
//                         the state after each round), lane-major
//                         (3, N, 65, 8): lane i of permutation p after round
//                         r at ((i * N + p) * 65 + r) * 8, so each lane is
//                         one column of the PoseidonTable's rows p*65 ..;
//   zk_poseidon_hash_many the sponge over N messages of L elements, zero
//                         padding to the rate, the capacity lane set to the
//                         Montgomery form of 2^64 * L (given by the caller).
//
// Elements are Montgomery Fr (R = 2^256, field.cuh's product), the same
// integers as the reference's (..., 16) limbs.
//
// Bound on the H100: one permutation does 80 S-boxes (24 in the full
// rounds, one per partial round), each two squarings and a product, and
// 64 MDS applications of 9 products: 160 squarings and 656 products,
// ~2.06e5 32-bit multiply instructions at 208 / 264 per squaring /
// product, against 192 bytes in and out (6.3 KB for the trace). So the
// kernel is bound by multiplies (16.7 T/s: 12.4 ns per permutation)
// whatever the output. Design: one permutation per thread, the three-word
// state in registers; the 64 x 3 round constants and the 3 x 3 MDS live in
// __constant__ memory (6.4 KB, set once per process by
// zk_poseidon_constants), read by every thread of a warp at the same
// address, which the constant cache broadcasts. The round kind is the
// same for every thread, so no branch diverges.

#include "field.cuh"

using namespace zk;

namespace {

constexpr int T = 3;
constexpr int RF_HALF = 4;
constexpr int RP = 56;
constexpr int ROUNDS = 2 * RF_HALF + RP;  // 64
constexpr int TRACE = ROUNDS + 1;         // 65 states per permutation

__constant__ uint32_t kRc[ROUNDS][T][8];
__constant__ uint32_t kMds[T][T][8];

__device__ __forceinline__ Fe const_fe(const uint32_t* w) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = w[i];
  return r;
}

__device__ __forceinline__ Fe sbox(const Fe& x) {
  Fe x2 = fe_sqr<FR>(x);
  Fe x4 = fe_sqr<FR>(x2);
  return fe_mul<FR>(x4, x);
}

// One round: add the round constants to all lanes, the S-box on every lane
// (full) or on lane 0 (partial), then the MDS product.
__device__ __forceinline__ void round_fn(Fe s[T], int r) {
#pragma unroll
  for (int i = 0; i < T; i++) s[i] = fe_add<FR>(s[i], const_fe(kRc[r][i]));
  if (r < RF_HALF || r >= RF_HALF + RP) {
#pragma unroll
    for (int i = 0; i < T; i++) s[i] = sbox(s[i]);
  } else {
    s[0] = sbox(s[0]);
  }
  Fe o[T];
#pragma unroll
  for (int j = 0; j < T; j++) {
    Fe acc = fe_mul<FR>(const_fe(kMds[j][0]), s[0]);
#pragma unroll
    for (int i = 1; i < T; i++) acc = fe_add<FR>(acc, fe_mul<FR>(const_fe(kMds[j][i]), s[i]));
    o[j] = acc;
  }
#pragma unroll
  for (int j = 0; j < T; j++) s[j] = o[j];
}

__device__ __forceinline__ void permute_fn(Fe s[T]) {
#pragma unroll 1
  for (int r = 0; r < ROUNDS; r++) round_fn(s, r);
}

__global__ void permute_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ in, i64 n) {
  for (i64 p = blockIdx.x * (i64)blockDim.x + threadIdx.x; p < n;
       p += (i64)gridDim.x * blockDim.x) {
    Fe s[T];
#pragma unroll
    for (int i = 0; i < T; i++) s[i] = fe_load(in + 8 * (T * p + i));
    permute_fn(s);
#pragma unroll
    for (int i = 0; i < T; i++) fe_store(out + 8 * (T * p + i), s[i]);
  }
}

__global__ void trace_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ in, i64 n) {
  for (i64 p = blockIdx.x * (i64)blockDim.x + threadIdx.x; p < n;
       p += (i64)gridDim.x * blockDim.x) {
    Fe s[T];
#pragma unroll
    for (int i = 0; i < T; i++) {
      s[i] = fe_load(in + 8 * (T * p + i));
      fe_store(out + 8 * ((i * n + p) * TRACE), s[i]);
    }
#pragma unroll 1
    for (int r = 0; r < ROUNDS; r++) {
      round_fn(s, r);
#pragma unroll
      for (int i = 0; i < T; i++) fe_store(out + 8 * ((i * n + p) * TRACE + r + 1), s[i]);
    }
  }
}

struct Word8 {
  uint32_t w[8];
};

__global__ void hash_many_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ msgs,
                                 i64 n, i64 len, Word8 cap) {
  for (i64 m = blockIdx.x * (i64)blockDim.x + threadIdx.x; m < n;
       m += (i64)gridDim.x * blockDim.x) {
    Fe s[T];
    s[0] = fe_zero();
    s[1] = fe_zero();
    s[2] = const_fe(cap.w);
    const uint32_t* msg = msgs + 8 * len * m;
    for (i64 i = 0; i < len; i += T - 1) {
      // absorb one rate-sized block; the zero padding past len adds nothing
#pragma unroll
      for (int j = 0; j < T - 1; j++)
        if (i + j < len) s[j] = fe_add<FR>(s[j], fe_load(msg + 8 * (i + j)));
      permute_fn(s);
    }
    fe_store(out + 8 * m, s[0]);
  }
}

}  // namespace

// rc: 64 x 3 x 8 words, mds: 3 x 3 x 8 words (host memory, Montgomery).
ZK_EXPORT int zk_poseidon_constants(const void* rc, const void* mds, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(kRc, rc, sizeof(kRc), 0, cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(kMds, mds, sizeof(kMds), 0, cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return (int)err;
}

// in, out: (n, 3, 8) words.
ZK_EXPORT int zk_poseidon_permute(void* out, const void* in, i64 n, void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  permute_kernel<<<zk_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, n);
  return (int)cudaGetLastError();
}

// in: (n, 3, 8) words; out: (3, n, 65, 8) words.
ZK_EXPORT int zk_poseidon_trace(void* out, const void* in, i64 n, void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  trace_kernel<<<zk_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, n);
  return (int)cudaGetLastError();
}

// msgs: (n, len, 8) words; out: (n, 8); cap: 8 words (host memory).
ZK_EXPORT int zk_poseidon_hash_many(void* out, const void* msgs, i64 n, i64 len,
                                    const uint32_t* cap, void* stream) {
  if (n == 0) return 0;
  if (len < 0) return (int)cudaErrorInvalidValue;
  Word8 c;
  for (int i = 0; i < 8; i++) c.w[i] = cap[i];
  const int threads = 128;
  hash_many_kernel<<<zk_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)msgs, n, len, c);
  return (int)cudaGetLastError();
}
