// Kernel G: the bucketed (Pippenger) MSM with private buckets per lane.
//
// Replaces zkevm_tpu/ec/pippenger.py: signed_digits, _accumulate and
// _accumulate_signed, _lane_merge, _weighted_fold, msm_t and PippengerMSMT
// (the commit engine of a params file loaded at k > 10, and of every mesh
// commitment). The wrapper (ec/pippenger.py) runs this file's kernels for
// windows of c <= LANE_MAX_C bits; wider windows, whose private buckets
// would fill device memory (2^c points per lane and window: 12.9 GB at the
// mesh engine's c = 16, Lw = 128), go through curve.cu's sorted
// accumulation with this file's digits. Both end with curve.cu's fold and
// warp Horner.
//
// Semantics kept from the reference: c-bit windows (W = ceil(num_bits / c),
// plus one carry window with signed digits), Lw lanes, point i on lane
// i % Lw at step i / Lw, 2^c buckets per (window, lane) (2^(c-1) + 1 with
// signed digits, the point's y negated for a negative digit); bucket 0
// never enters the fold.
//
// Bound on the H100: ~W * n * (1 - 2^-c) mixed additions of ~2,680 32-bit
// multiply instructions each (7M + 4S over the affine bases), so the card's
// int32 rate, not its memory, bounds it. Design:
//   1. digits: one thread per digit, or with signed digits one per scalar
//      writing its WD = W + 1 digits, so that a window's carry is computed
//      once;
//   2. accumulate: one thread per (lane, window), t = lane * WD + window,
//      adds the lane's points into its B - 1 buckets with mixed additions,
//      in step order within each bucket. No bucket lives in device memory
//      while it is summed: the thread first sorts its steps by digit (a
//      counting sort, its counters in shared memory, the sorted steps in
//      its own row of scratch, written 16 bytes at a time), then sums one
//      bucket at a time in registers and writes it once. Private buckets
//      in shared memory (1,440 bytes a thread at c = 4) would hold an SM
//      to four warps; this way the registers set the occupancy, as in C's
//      accumulation;
//   3. lane merge: a halving tree over the lanes, one launch per level (the
//      lane count padded to a power of two with identities), buckets 1..B-1.
// Every step adds in a fixed order, so the plain PyTorch version in
// ec/pippenger.py reproduces the Jacobian words bit for bit.

#include "curve.cuh"

using namespace zk;

namespace {

// digits[i * WD + w]: window w of scalar i (standard form). Unsigned: bits
// [w*c, w*c + c), one thread per digit so that the writes coalesce. Signed:
// one thread per scalar, d = window + carry; d > 2^(c-1) becomes
// -(2^c - d) with a carry into the next window; the last of the WD = W + 1
// digits is the top carry.
__global__ void digits_kernel(int* __restrict__ digits, const uint32_t* __restrict__ scalars,
                              i64 n, int c, int windows, int is_signed) {
  const int wd = windows + is_signed;
  const uint32_t half = 1u << (c - 1), full = 1u << c, mask = full - 1u;
  if (!is_signed) {
    for (i64 t = blockIdx.x * (i64)blockDim.x + threadIdx.x; t < n * windows;
         t += (i64)gridDim.x * blockDim.x) {
      const i64 i = t / windows;
      const int start = (int)(t - i * windows) * c;
      const int word = start >> 5, off = start & 31;
      uint32_t v = scalars[8 * i + word] >> off;
      if (off + c > 32 && word + 1 < 8) v |= scalars[8 * i + word + 1] << (32 - off);
      digits[t] = (int)(v & mask);
    }
    return;
  }
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    uint32_t s[8];
#pragma unroll
    for (int j = 0; j < 8; j++) s[j] = scalars[8 * i + j];
    uint32_t carry = 0;
    for (int w = 0; w < windows; w++) {
      int start = w * c;
      int word = start >> 5, off = start & 31;
      uint32_t v = s[word] >> off;
      if (off + c > 32 && word + 1 < 8) v |= s[word + 1] << (32 - off);
      const uint32_t d = (v & mask) + carry;
      carry = d > half ? 1u : 0u;
      digits[i * wd + w] = carry ? -(int)(full - d) : (int)d;
    }
    digits[i * wd + windows] = (int)carry;
  }
}

// Buckets 1..B-1 of thread t = lane * WD + w: the sums, in step order, of
// the points i = s * Lw + lane whose digit in window w is b. The thread
// counts its digits, writes its steps sorted by bucket (stable, so in step
// order within a bucket; ~s for a negative digit) to its own row of
// `order`, then adds them bucket after bucket into one accumulator in
// registers and writes each bucket once, to buckets[t] (slot 0 the
// identity). A bucket's steps start on a 16-byte boundary of the row and
// are staged four at a time in shared memory, so that they leave as one
// 16-byte store: a store a step, each to a different line, was the
// costliest part of the sort.
constexpr int ACC_THREADS = 128;
constexpr int ACC_MAX_B = 16;  // 2^c buckets at c <= LANE_MAX_C = 4

__global__ void __launch_bounds__(ACC_THREADS) accumulate_kernel(
    uint32_t* __restrict__ buckets, const uint32_t* __restrict__ affine, const int* __restrict__ digits,
    int* __restrict__ order, i64 row_len, i64 S, i64 Lw, int wd, int B) {
  __shared__ int ends[ACC_MAX_B * ACC_THREADS];      // this thread's bucket b at b * ACC_THREADS + me
  __shared__ int staged[ACC_MAX_B * 4 * ACC_THREADS];  // its bucket b's last four steps
  const i64 T = Lw * wd;
  const int me = threadIdx.x;
  for (i64 t = blockIdx.x * (i64)blockDim.x + threadIdx.x; t < T;
       t += (i64)gridDim.x * blockDim.x) {
    const i64 lane = t / wd;
    for (int b = 0; b < B; b++) ends[b * ACC_THREADS + me] = 0;
    for (i64 s = 0; s < S; s++) {
      const int d = digits[s * T + t];  // = digits[(s * Lw + lane) * wd + w]
      ends[(d < 0 ? -d : d) * ACC_THREADS + me]++;
    }
    int total = 0, next = 0;  // bucket 0 dropped; ends[b] = start of bucket b, a multiple of 4
    for (int b = 1; b < B; b++) {
      const int count = ends[b * ACC_THREADS + me];
      ends[b * ACC_THREADS + me] = next;
      next = (next + count + 3) & ~3;
      total += count;
    }
    int* row = order + t * row_len;
    for (i64 s = 0; s < S; s++) {
      const int d = digits[s * T + t];
      if (d == 0) continue;
      const int b = d < 0 ? -d : d;
      const int k = ends[b * ACC_THREADS + me]++;  // ends[b] becomes its end
      int* stage = staged + b * 4 * ACC_THREADS + me;
      stage[(k & 3) * ACC_THREADS] = d < 0 ? ~(int)s : (int)s;
      if ((k & 3) == 3)
        *reinterpret_cast<int4*>(row + k - 3) =
            make_int4(stage[0], stage[ACC_THREADS], stage[2 * ACC_THREADS], stage[3 * ACC_THREADS]);
    }
    for (int b = 1; b < B; b++) {
      const int end = ends[b * ACC_THREADS + me];
      for (int q = 0; q < (end & 3); q++) row[(end & ~3) + q] = staged[(b * 4 + q) * ACC_THREADS + me];
    }
    uint32_t* out = buckets + 24 * B * t;
    pt_store(out, pt_identity());
    Pt acc = pt_identity();
    int b = 1, k = 0;
    for (int i = 0; i < total; i++) {
      while (k == ends[b * ACC_THREADS + me]) {
        pt_store(out + 24 * b, acc);
        acc = pt_identity();
        b++;
        k = (k + 3) & ~3;
      }
      const int e = row[k++];
      const bool neg = e < 0;
      const uint32_t* src = affine + 16 * ((neg ? ~e : e) * Lw + lane);
      Fe y = fe_load(src + 8);
      if (neg) y = fq_neg<Ptx>(y);
      acc = pt_madd<Ptx>(acc, fe_load(src), y);
    }
    for (; b < B; b++) {
      pt_store(out + 24 * b, acc);
      acc = pt_identity();
    }
  }
}

// One level of the lane merge over (lanes * WD, B, 24) buffers: out lane j
// = in lane j + in lane j + half (the identity where j + half >= m), for
// buckets 1..B-1 of every window; neighbouring threads take neighbouring
// buckets.
__global__ void lane_halve_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ in,
                                  i64 m, i64 half, int wd, int B) {
  const i64 total = half * wd * (B - 1);
  for (i64 u = blockIdx.x * (i64)blockDim.x + threadIdx.x; u < total;
       u += (i64)gridDim.x * blockDim.x) {
    const i64 t = u / (B - 1);
    const i64 slot = 24 * (t * B + 1 + (u - t * (B - 1)));  // bucket b of thread t
    const i64 far = 24 * half * wd * B;                      // lane j + half
    Pt q = t / wd + half < m ? pt_load(in + slot + far) : pt_identity();
    pt_store(out + slot, pt_add<Ptx>(pt_load(in + slot), q));
  }
}

}  // namespace

ZK_EXPORT int zk_pip_digits(void* digits, const void* scalars, i64 n, i64 c, i64 windows,
                            i64 is_signed, void* stream) {
  if (c < 1 || c > 16 || windows < 1 || windows * c > 256 + c - 1 || (is_signed != 0 && is_signed != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  digits_kernel<<<zk_blocks(is_signed ? n : n * windows, 256), 256, 0, (cudaStream_t)stream>>>(
      (int*)digits, (const uint32_t*)scalars, n, (int)c, (int)windows, (int)is_signed);
  return (int)cudaGetLastError();
}

// buckets: (Lw * wd, B, 24) words; affine: (S * Lw, 16); order: Lw * wd rows of row_len
// ints of scratch, 16-byte aligned, row_len a multiple of 4 and at least S + 3 (B - 1): each
// bucket's steps start on a multiple of 4.
ZK_EXPORT int zk_pip_accumulate(void* buckets, const void* affine, const void* digits, void* order,
                                i64 row_len, i64 S, i64 Lw, i64 wd, i64 B, void* stream) {
  if (S < 1 || S > (1LL << 30) || Lw < 1 || wd < 1 || B < 2 || B > ACC_MAX_B || row_len % 4 ||
      row_len < S + 3 * (B - 1) || ((uintptr_t)order & 15))
    return (int)cudaErrorInvalidValue;
  accumulate_kernel<<<zk_blocks(Lw * wd, ACC_THREADS), ACC_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)buckets, (const uint32_t*)affine, (const int*)digits, (int*)order, row_len, S, Lw, (int)wd,
      (int)B);
  return (int)cudaGetLastError();
}

// in: (m * wd, B, 24); out: (half * wd, B, 24).
ZK_EXPORT int zk_pip_lane_halve(void* out, const void* in, i64 m, i64 half, i64 wd, i64 B,
                                void* stream) {
  if (half < 1 || half >= m || 2 * half < m || wd < 1 || B < 2) return (int)cudaErrorInvalidValue;
  lane_halve_kernel<<<zk_blocks((B - 1) * half * wd, 128), 128, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, m, half, (int)wd, (int)B);
  return (int)cudaGetLastError();
}
