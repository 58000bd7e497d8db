// Kernel B: radix-2 NTT over BN254 Fr on a batch of columns, with the coset
// shift and the inverse's 1/n fused into its loads and stores.
//
// Replaces zkevm_tpu/poly/ntt.py::_fft_core (via ntt / intt), with
// scale_by_powers, coset_ntt and coset_intt: the transform of every column,
// natural order in and out, each input element j times pre[j] (the coset
// powers s^j) as it is loaded and each output element i times post[i] (or
// one scale, 1/n) as it is stored.
//
// Bound on the H100: k n/2 butterflies (a Montgomery product, an addition
// and a subtraction each) against 64 bytes read and written once an
// element: the operations bound it. Design: at most three passes through
// device memory. A transform of n = 2^k <= 2^12 elements is one pass: each
// block holds whole transforms in shared memory. Up to 2^24, the transform
// is the four-step split of kernel I (n1 = 2^(k/2) rows of n2 = 2^(k - k/2)),
// without I's transpose:
//   1. column pass: the size-n1 transform of every column (pre[j] applied
//      on its loads), each output times w^(r c) (w the 2^k-th root, r the
//      output row, c the column) as it is stored in a scratch buffer;
//   2. row pass: the size-n2 transform of every row r, whose element c is
//      X[r + n1 c] of the result: stored there directly (runs of a block's
//      consecutive rows are contiguous), times post.
// Up to 2^36, a first column pass of n0 = 2^(k/3) rows leaves n0 rows of
// 2^(k - k/3) elements, and the two passes above transform every one of
// them, the row pass storing element c of row r at r + n0 c (log_outer).
// Sub-transforms run all their stages in shared memory, inputs loaded in
// bit-reversed order (the bit reversal is folded into the loads), and their
// twiddles, the 2^(m-1) powers of the 2^m-th root, are staged once per
// block into shared memory with cp.async: no device read per butterfly.
// The load and store loops are unrolled so that a thread's loads (and its
// coset powers) are all in flight before its first product, which is
// field.cuh's product inlined (a called copy ran slower here;
// scripts/probe_quotient.py --alt times both). The wrapper (poly/ntt.py,
// fft_passes) runs the passes over groups of columns through one scratch
// buffer of at most 2^25 elements.

#include "ntt_common.cuh"

using namespace zk;

namespace {

constexpr int TILE_LOG = 11;     // elements the sub-transforms of one block hold together
constexpr int MAX_SUB_LOG = 12;  // the largest sub-transform: 2^12 elements, 128 KB
constexpr int THREADS = 512;

// Copy the table of v^j, j < 2^(m-1), into shared memory (cp.async, 16
// bytes a thread a step) and wait for it.
__device__ void stage_twiddles(uint32_t* shtw, const uint32_t* __restrict__ tw, int m) {
  const int chunks = 2 << (m - 1);  // 16-byte halves of 2^(m-1) elements
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(shtw + 4 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(tw + 4 * i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;\n" ::: "memory");
}

// Column pass: `in` holds `batch` matrices of n1 = 2^k1 rows by n2 =
// 2^(k - k1) columns; the block takes cb = 2^logcb adjacent columns of one.
// tw_k: w^j, j < 2^(k-1); tw_sub: the 2^k1-th root's powers; pre: null or
// (n1 n2) elements.
__global__ void __launch_bounds__(THREADS) cols_kernel(
    uint32_t* __restrict__ out, const uint32_t* __restrict__ in, const uint32_t* __restrict__ tw_k,
    const uint32_t* __restrict__ tw_sub, const uint32_t* __restrict__ pre, int k, int k1, int logcb) {
  extern __shared__ uint4 sh_raw[];  // 16-byte aligned for vector access
  uint32_t* sh = reinterpret_cast<uint32_t*>(sh_raw);
  const int k2 = k - k1;
  const int cb = 1 << logcb;
  const int tile = cb << k1;
  uint32_t* shtw = sh + 8 * tile;
  const i64 blocks_per_matrix = 1LL << (k2 - logcb);
  const i64 b = blockIdx.x / blocks_per_matrix;
  const i64 col = (blockIdx.x % blocks_per_matrix) << logcb;
  const uint32_t* src = in + 8 * ((b << k) + col);
  uint32_t* dst = out + 8 * ((b << k) + col);
#pragma unroll 4
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int r = e >> logcb, cc = e & (cb - 1);
    const i64 j = ((i64)r << k2) + cc;
    Fe x = fe_load(src + 8 * j);
    if (pre != nullptr) x = fe_mul<FR>(x, fe_load(pre + 8 * (j + col)));
    fe_store(sh + 8 * ((cc << k1) + bitrev(r, k1)), x);
  }
  stage_twiddles(shtw, tw_sub, k1);
  __syncthreads();
  sub_transforms_by<SharedTwiddles>(sh, SharedTwiddles{shtw, k1}, k1, cb);
#pragma unroll 4
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int r = e >> logcb, cc = e & (cb - 1);
    Fe x = fe_load(sh + 8 * ((cc << k1) + r));
    const i64 ex = (i64)r * (col + cc);
    if (ex) x = fe_mul<FR>(x, power(tw_k, ex, k));
    fe_store(dst + 8 * (((i64)r << k2) + cc), x);
  }
}

// Row pass: `rows` rows of n2 = 2^k2 elements, contiguous; row R is row
// r = R mod n1 of matrix b = R / n1 (n1 = 2^log_n1), and its element c is
// element i = r + n1 c of transform b's result (n1 = 1: the row is the whole
// transform). Transform b is itself row b mod n0 (n0 = 2^log_outer) of an
// outer split of output column b / n0, its element i that column's element
// b mod n0 + n0 i (n0 = 1: transform b is the column). The block takes rb =
// 2^logrb consecutive rows. pre (only where n1 = n0 = 1): null or n2
// elements; post: null or one column's elements by output index; scale:
// null or one element (used where post is null).
__global__ void __launch_bounds__(THREADS) rows_kernel(
    uint32_t* __restrict__ out, const uint32_t* __restrict__ in, const uint32_t* __restrict__ tw_sub,
    const uint32_t* __restrict__ pre, const uint32_t* __restrict__ post,
    const uint32_t* __restrict__ scale, int k2, int log_n1, int log_outer, int logrb) {
  extern __shared__ uint4 sh_raw[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(sh_raw);
  const int n2 = 1 << k2;
  const int rb = 1 << logrb;
  const int tile = rb << k2;
  uint32_t* shtw = sh + 8 * tile;
  const i64 row0 = (i64)blockIdx.x << logrb;
  const uint32_t* src = in + 8 * (row0 << k2);
#pragma unroll 4
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int rr = e >> k2, c = e & (n2 - 1);
    Fe x = fe_load(src + 8 * (i64)e);
    if (pre != nullptr) x = fe_mul<FR>(x, fe_load(pre + 8 * c));
    fe_store(sh + 8 * ((rr << k2) + bitrev(c, k2)), x);
  }
  stage_twiddles(shtw, tw_sub, k2);
  __syncthreads();
  sub_transforms_by<SharedTwiddles>(sh, SharedTwiddles{shtw, k2}, k2, rb);
  Fe sc;
  if (post == nullptr && scale != nullptr) sc = fe_load(scale);
#pragma unroll 4
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    // neighbouring threads store neighbouring elements: along the row where
    // it is the whole transform, across the block's rows otherwise
    const int c = log_n1 ? e >> logrb : e & (n2 - 1);
    const int rr = log_n1 ? e & (rb - 1) : e >> k2;
    Fe x = fe_load(sh + 8 * ((rr << k2) + c));
    const i64 R = row0 + rr, b = R >> log_n1;
    const i64 i = (R & ((1LL << log_n1) - 1)) + ((i64)c << log_n1);  // index in transform b
    const i64 o = (b & ((1LL << log_outer) - 1)) + (i << log_outer);  // index in the output column
    if (post != nullptr)
      x = fe_mul<FR>(x, fe_load(post + 8 * o));
    else if (scale != nullptr)
      x = fe_mul<FR>(x, sc);
    fe_store(out + 8 * (((b >> log_outer) << (k2 + log_n1 + log_outer)) + o), x);
  }
}

// log2 of the largest power of two <= 2^TILE_LOG / 2^sub_log that divides count.
int tile_count_log(int sub_log, i64 count) {
  int lg = sub_log >= TILE_LOG ? 0 : TILE_LOG - sub_log;
  while (lg > 0 && (count & ((1LL << lg) - 1))) lg--;
  return lg;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Column pass of `batch` transforms of 2^k (k1 <= 12 row bits, k - k1 <= 24
// column bits); out: the same shape, what the next pass reads.
ZK_EXPORT int zk_ntt_cols(void* out, const void* in, const void* tw_k, const void* tw_sub,
                          const void* pre, i64 k, i64 k1, i64 batch, void* stream) {
  if (k < 2 || k > 3 * MAX_SUB_LOG || k1 < 1 || k1 > MAX_SUB_LOG || k - k1 < 1 ||
      k - k1 > 2 * MAX_SUB_LOG || batch < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int logcb = tile_count_log((int)k1, 1LL << (k - k1));
  const size_t smem = ((size_t)32 << (logcb + k1)) + ((size_t)16 << k1);
  const i64 blocks = batch << (k - k1 - logcb);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int err = set_smem(cols_kernel, smem);
  if (err) return err;
  cols_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, (const uint32_t*)tw_k, (const uint32_t*)tw_sub,
      (const uint32_t*)pre, (int)k, (int)k1, logcb);
  return (int)cudaGetLastError();
}

// Row pass over `rows` rows of 2^k2 elements, each row r of a matrix of
// 2^log_n1 rows, each matrix row b of an outer split of 2^log_outer rows (see
// rows_kernel); pre only where log_n1 = log_outer = 0.
ZK_EXPORT int zk_ntt_rows(void* out, const void* in, const void* tw_sub, const void* pre,
                          const void* post, const void* scale, i64 k2, i64 log_n1, i64 log_outer,
                          i64 rows, void* stream) {
  if (k2 < 1 || k2 > MAX_SUB_LOG || log_n1 < 0 || log_n1 > MAX_SUB_LOG || log_outer < 0 ||
      log_outer > MAX_SUB_LOG || rows < 0 || (rows & ((1LL << (log_n1 + log_outer)) - 1)) ||
      (pre != nullptr && log_n1 + log_outer != 0))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int logrb = tile_count_log((int)k2, rows);
  const size_t smem = ((size_t)32 << (logrb + k2)) + ((size_t)16 << k2);
  const i64 blocks = rows >> logrb;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int err = set_smem(rows_kernel, smem);
  if (err) return err;
  rows_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, (const uint32_t*)tw_sub, (const uint32_t*)pre,
      (const uint32_t*)post, (const uint32_t*)scale, (int)k2, (int)log_n1, (int)log_outer, logrb);
  return (int)cudaGetLastError();
}
