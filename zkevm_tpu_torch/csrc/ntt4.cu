// Kernel I: the four-step (Bailey) NTT over BN254 Fr.
//
// Replaces zkevm_tpu/poly/ntt.py::ntt_t / intt_t (with _ntt_axis2 and
// _fourstep_twiddle), and is the local work of
// zkevm_tpu/parallel/mesh.py::sharded_ntt_t. A transform of n = 2^k
// elements, natural order in and out, is viewed as an (n1, n2) matrix of
// n1 = 2^(k/2) rows and n2 = 2^(k - k/2) columns (the reference's split):
//   1. column pass: a size-n1 NTT down every column, each output times
//      w^(r * c) as it is stored (w the 2^k-th root, r the output row, c the
//      column's index in the whole matrix);
//   2. row pass: a size-n2 NTT along every row, times 1/n for an inverse;
//   3. transpose (n1, n2) -> (n2, n1): the flattened result is the natural
//      order X[r + n1 * j].
// At k <= 7 the reference runs one radix-2 transform; that is the row pass
// alone, on rows of n elements.
//
// Bound on the H100: the transform does k * n/2 butterflies (a Montgomery
// product, an addition and a subtraction each) and n twiddle products, about
// 160 multiply instructions per element at k = 22 against 64 bytes read and
// written once, so it is bound by operations. Design: every sub-transform
// runs all its stages in shared memory (up to 2^12 elements of 32 bytes,
// 128 KB), so the whole transform is three passes through device memory,
// where kernel B makes one pass per stage above its tenth. A block of the
// column pass takes 2^11 / n1 adjacent columns, so that neighbouring threads
// read neighbouring elements of a row. Every twiddle comes from one table of
// w^j, j < n/2 (the port's cached omega powers): stage s of a sub-transform
// uses w^(j * 2^(k - s)), and the four-step twiddle w^e with e >= n/2 is
// -w^(e - n/2). The row pass reads a row that arrives in `parts` blocks of
// n2 / parts elements (the layout all_to_all leaves on one rank of the
// sharded transform), so the mesh needs no rearranging copy.

#include "ntt_common.cuh"

using namespace zk;

namespace {

constexpr int TILE_LOG = 11;     // elements the sub-transforms of one block hold together
constexpr int MAX_SUB_LOG = 12;  // the largest sub-transform: 2^12 elements, 128 KB
constexpr int THREADS = 256;
constexpr int TT = 32;           // transpose tile: 32 x 32 elements

// in: `batch` matrices of n1 = 2^k1 rows, row pitch `ld` elements; columns
// [0, ncols) of each (in points at the first). out: (batch, n1, ncols).
// Block: cb adjacent columns of one matrix.
__global__ void cols_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ in,
                            const uint32_t* __restrict__ tw, int k, int k1, i64 ld, i64 ncols,
                            i64 c0, int logcb) {
  extern __shared__ uint4 sh_raw[];  // 16-byte aligned for vector access
  uint32_t* sh = reinterpret_cast<uint32_t*>(sh_raw);
  const int n1 = 1 << k1;
  const int cb = 1 << logcb;
  const i64 blocks_per_matrix = ncols >> logcb;
  const i64 b = blockIdx.x / blocks_per_matrix;
  const i64 col = (blockIdx.x % blocks_per_matrix) << logcb;
  const uint32_t* src = in + 8 * (b * n1 * ld + col);
  uint32_t* dst = out + 8 * (b * n1 * ncols + col);
  const int tile = cb << k1;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int r = e >> logcb, cc = e & (cb - 1);
    copy_elem(sh + 8 * ((cc << k1) + bitrev(r, k1)), src + 8 * ((i64)r * ld + cc));
  }
  __syncthreads();
  sub_transforms(sh, tw, k, k1, cb);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int r = e >> logcb, cc = e & (cb - 1);
    Fe x = fe_load(sh + 8 * ((cc << k1) + r));
    const i64 ex = (i64)r * (c0 + col + cc);
    if (ex) x = fe_mul<FR>(x, power(tw, ex, k));
    fe_store(dst + 8 * ((i64)r * ncols + cc), x);
  }
}

// Rows of n2 = 2^k2 elements; element c of row r lies in block p = c >> logw
// at in + 8 * ((p * rows + r) << logw) + 8 * (c & (2^logw - 1)).
// out: (rows, n2), each element times *scale when scale is given.
// Block: rb consecutive rows.
__global__ void rows_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ in,
                            const uint32_t* __restrict__ tw, const uint32_t* __restrict__ scale,
                            int k, int k2, i64 rows, int logw, int logrb) {
  extern __shared__ uint4 sh_raw[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(sh_raw);
  const i64 row0 = (i64)blockIdx.x << logrb;
  const int tile = 1 << (logrb + k2);
  const i64 wmask = (1LL << logw) - 1;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int rr = e >> k2, c = e & ((1 << k2) - 1);
    const i64 p = c >> logw;
    const uint32_t* s = in + 8 * (((p * rows + row0 + rr) << logw) + (c & wmask));
    copy_elem(sh + 8 * ((rr << k2) + bitrev(c, k2)), s);
  }
  __syncthreads();
  sub_transforms(sh, tw, k, k2, 1 << logrb);
  uint32_t* dst = out + 8 * (row0 << k2);
  if (scale == nullptr) {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) copy_elem(dst + 8 * e, sh + 8 * e);
  } else {
    const Fe sc = fe_load(scale);
    for (int e = threadIdx.x; e < tile; e += blockDim.x)
      fe_store(dst + 8 * e, fe_mul<FR>(fe_load(sh + 8 * e), sc));
  }
}

// (batch, R, S) -> (batch, S, R) through a shared 32 x 32 tile. An element is
// two 16-byte halves; the tile's row pitch of 66 halves puts the eight
// halves a quarter warp reads in either phase on distinct banks.
__global__ void transpose_kernel(uint4* __restrict__ out, const uint4* __restrict__ in, i64 R,
                                 i64 S) {
  __shared__ uint4 tile[TT][2 * TT + 2];
  const i64 base = 2 * (i64)blockIdx.z * R * S;
  const i64 r0 = (i64)blockIdx.y * TT, s0 = (i64)blockIdx.x * TT;
  for (int idx = threadIdx.x; idx < TT * TT * 2; idx += blockDim.x) {
    const int h = idx & 1, i = (idx >> 1) / TT, j = (idx >> 1) % TT;
    if (r0 + i < R && s0 + j < S) tile[i][2 * j + h] = in[base + 2 * ((r0 + i) * S + s0 + j) + h];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TT * TT * 2; idx += blockDim.x) {
    const int h = idx & 1, j = (idx >> 1) / TT, i = (idx >> 1) % TT;
    if (r0 + i < R && s0 + j < S) out[base + 2 * ((s0 + j) * R + r0 + i) + h] = tile[i][2 * j + h];
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

bool pow2(i64 x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// Column pass over columns [0, ncols) of `batch` matrices (n1 = 2^k1 rows,
// row pitch ld) starting at `in`; twiddle w^(r * (c0 + c)) for the 2^k-point
// root whose powers are `tw` (2^(k-1) entries). out: (batch, n1, ncols).
ZK_EXPORT int zk_ntt4_cols(void* out, const void* in, const void* tw, i64 k, i64 k1, i64 ld,
                           i64 ncols, i64 c0, i64 batch, void* stream) {
  if (k < 1 || k > 30 || k1 < 0 || k1 > MAX_SUB_LOG || k1 > k || !pow2(ncols) || ld < ncols ||
      c0 < 0 || c0 + ncols > (1LL << (k - k1)) || batch < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int logcb = tile_count_log((int)k1, ncols);
  const size_t smem = (size_t)32 << (logcb + k1);
  const i64 blocks = batch * (ncols >> logcb);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int err = set_smem(cols_kernel, smem);
  if (err) return err;
  cols_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, (const uint32_t*)tw, (int)k, (int)k1, ld, ncols, c0,
      logcb);
  return (int)cudaGetLastError();
}

// Row pass over `rows` rows of 2^k2 elements, each row in `parts` blocks
// (see rows_kernel); scale is null or one Montgomery element. out: (rows, 2^k2).
ZK_EXPORT int zk_ntt4_rows(void* out, const void* in, const void* tw, const void* scale, i64 k,
                           i64 k2, i64 rows, i64 parts, void* stream) {
  if (k < 1 || k > 30 || k2 < 1 || k2 > MAX_SUB_LOG || k2 > k || rows < 0 || !pow2(parts) ||
      parts > (1LL << k2))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int logw = (int)k2;
  for (i64 p = parts; p > 1; p >>= 1) logw--;
  const int logrb = tile_count_log((int)k2, rows);
  const size_t smem = (size_t)32 << (logrb + k2);
  const i64 blocks = rows >> logrb;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int err = set_smem(rows_kernel, smem);
  if (err) return err;
  rows_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, (const uint32_t*)tw, (const uint32_t*)scale, (int)k,
      (int)k2, rows, logw, logrb);
  return (int)cudaGetLastError();
}

// (batch, R, S) elements -> (batch, S, R).
ZK_EXPORT int zk_ntt4_transpose(void* out, const void* in, i64 R, i64 S, i64 batch, void* stream) {
  if (R < 0 || S < 0 || batch < 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (R == 0 || S == 0 || batch == 0) return 0;
  const i64 gx = (S + TT - 1) / TT, gy = (R + TT - 1) / TT;
  if (gx >= (1LL << 31) || gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)batch);
  transpose_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((uint4*)out, (const uint4*)in, R,
                                                               S);
  return (int)cudaGetLastError();
}
