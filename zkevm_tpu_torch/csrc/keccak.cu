// Kernel D: Keccak-f[1600] and the keccak256 sponge.
//
// Replaces zkevm_tpu/hash/keccak.py: keccak_f (24 rounds on (..., 25, 2)
// 32-bit lo/hi lanes, because the TPU has no 64-bit integer path),
// keccak256 and keccak256_batch (rate 136 bytes, keccak pad 0x01 ... 0x80).
//
// Bound on the H100: one permutation is ~2k 64-bit logic operations on a
// 200-byte state, so a batch is bound by integer logic throughput, and a
// single transcript hash (up to ~17 KB, 128 blocks) by the latency of one
// thread's sequential sponge. Design: native 64-bit lanes, one state per
// thread held in registers, the lane loops of each round unrolled; the sponge
// kernel absorbs every block of its message inside the thread, so a long
// transcript message costs one launch.

#include "common.cuh"

namespace {

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// Rotation offsets for lane 5y + x.
__device__ __forceinline__ int rot_offset(int lane) {
  constexpr int R[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                         25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  return R[lane];
}

__device__ __forceinline__ uint64_t rotl(uint64_t v, int r) {
  return r == 0 ? v : (v << r) | (v >> (64 - r));
}

__device__ void keccak_f1600(uint64_t a[25]) {
#pragma unroll 1
  for (int rnd = 0; rnd < 24; rnd++) {
    uint64_t c[5], d[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
#pragma unroll
    for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
    // rho + pi: B[y, 2x + 3y] = rot(A[x, y])
#pragma unroll
    for (int y = 0; y < 5; y++) {
#pragma unroll
      for (int x = 0; x < 5; x++) {
        int nx = y, ny = (2 * x + 3 * y) % 5;
        b[5 * ny + nx] = rotl(a[5 * y + x], rot_offset(5 * y + x));
      }
    }
    // chi
#pragma unroll
    for (int y = 0; y < 5; y++) {
#pragma unroll
      for (int x = 0; x < 5; x++) {
        a[5 * y + x] = b[5 * y + x] ^ (~b[5 * y + (x + 1) % 5] & b[5 * y + (x + 2) % 5]);
      }
    }
    a[0] ^= kRC[rnd];
  }
}

__global__ void permute_kernel(uint64_t* __restrict__ states, i64 n) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    uint64_t a[25];
#pragma unroll
    for (int l = 0; l < 25; l++) a[l] = states[25 * i + l];
    keccak_f1600(a);
#pragma unroll
    for (int l = 0; l < 25; l++) states[25 * i + l] = a[l];
  }
}

// blocks: (n, max_blocks, 17) padded rate blocks; nblocks[i] of them are
// message i's; digest: (n, 4) lanes of the squeezed state.
__global__ void sponge_kernel(const uint64_t* __restrict__ blocks, const int* __restrict__ nblocks,
                              i64 max_blocks, uint64_t* __restrict__ digest, i64 n) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    uint64_t a[25];
#pragma unroll
    for (int l = 0; l < 25; l++) a[l] = 0;
    const uint64_t* blk = blocks + 17 * max_blocks * i;
    for (int j = 0; j < nblocks[i]; j++) {
#pragma unroll
      for (int l = 0; l < 17; l++) a[l] ^= blk[17 * j + l];
      keccak_f1600(a);
    }
#pragma unroll
    for (int l = 0; l < 4; l++) digest[4 * i + l] = a[l];
  }
}

}  // namespace

ZK_EXPORT int zk_keccak_f(void* states, i64 n, void* stream) {
  if (n == 0) return 0;
  permute_kernel<<<zk_blocks(n, 128), 128, 0, (cudaStream_t)stream>>>((uint64_t*)states, n);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_keccak_sponge(const void* blocks, const void* nblocks, i64 max_blocks,
                               void* digest, i64 n, void* stream) {
  if (n == 0) return 0;
  sponge_kernel<<<zk_blocks(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)blocks, (const int*)nblocks, max_blocks, (uint64_t*)digest, n);
  return (int)cudaGetLastError();
}
