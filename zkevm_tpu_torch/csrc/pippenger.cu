// Kernel G: the bucketed (Pippenger) MSM with private buckets and no sort.
//
// Replaces zkevm_tpu/ec/pippenger.py: signed_digits, _accumulate and
// _accumulate_signed, _lane_merge, _weighted_fold, msm_t and PippengerMSMT
// (the commit engine of a params file loaded at k > 10). _horner is
// curve.cu's zk_g1_horner, launched by the wrapper.
//
// Semantics kept from the reference: c-bit windows (W = ceil(num_bits / c),
// plus one carry window with signed digits), Lw lanes, point i on lane
// i % Lw at step i / Lw, 2^c buckets per (window, lane) (2^(c-1) + 1 with
// signed digits, the point's y negated for a negative digit); bucket 0
// never enters the fold.
//
// Bound on the H100: ~W * n * (1 - 2^-c) complete additions of ~3,944
// 32-bit multiply instructions each, so the card's int32 rate, not its
// memory, bounds it. Design:
//   1. digits: one thread per scalar writes its WD = W (+1 signed) digits
//      as signed ints, so that a window's carry is computed once;
//   2. accumulate: one thread per (lane, window), t = lane * WD + window,
//      loops over the lane's points in order. The threads of one lane read
//      the same point (a broadcast load) and neighbouring threads read
//      neighbouring digits. Buckets live in device memory thread-major,
//      (T, B, 24): the threads of a warp pick different buckets, so each
//      thread's bucket is 96 contiguous bytes, read and written as six
//      16-byte vectors that use every byte of the sectors they touch (a
//      word-major layout would touch a sector per word);
//   3. lane merge: a halving tree over the lanes, one launch per level (the
//      lane count padded to a power of two with identities), buckets 1..B-1;
//   4. fold sum_b b * S_b, in two launches: the buckets of a window in P
//      segments of L = min(256, 2^ceil(log2 B)) (buckets 0 and >= B count as
//      the identity), one thread per (window, segment) keeping running sums
//      from its top bucket down (sum_j = sum S_b, total_j = sum (b - jL) S_b);
//      then one thread per window: U += sum_j, T += U (j > 0), R += total_j
//      for j = P-1..0, and R + L * T (log2 L doublings) = sum_b b * S_b, into
//      the (WD, 24) layout that zk_g1_horner reads. At c = 16 a window's
//      65,535 buckets were one thread's serial chain of 131,070 additions;
//      now the longest chain is 2L + 3P. With P = 1 the words equal those of
//      a single running sum.
// Every step adds in a fixed order, so the plain PyTorch version in
// ec/pippenger.py reproduces the Jacobian words bit for bit.

#include "curve.cuh"

using namespace zk;

namespace {

// digits[i * WD + w]: window w of scalar i (standard form). Unsigned: bits
// [w*c, w*c + c). Signed: d = window + carry; d > 2^(c-1) becomes
// -(2^c - d) with a carry into the next window; the last of the WD = W + 1
// digits is the top carry.
__global__ void digits_kernel(int* __restrict__ digits, const uint32_t* __restrict__ scalars,
                              i64 n, int c, int windows, int is_signed) {
  const int wd = windows + is_signed;
  const uint32_t half = 1u << (c - 1), full = 1u << c, mask = full - 1u;
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
      uint32_t d = (v & mask) + carry;
      int out = (int)d;
      if (is_signed) {
        carry = d > half ? 1u : 0u;
        out = carry ? -(int)(full - d) : (int)d;
      }
      digits[i * wd + w] = out;
    }
    if (is_signed) digits[i * wd + windows] = (int)carry;
  }
}

// Buckets 1..B-1 of thread t = lane * WD + w accumulate, in step order, the
// points i = s * Lw + lane whose digit in window w is not zero. Four blocks
// of 128 threads per SM cap the registers at 128 (a few bytes spill, where
// ptxas alone takes 218): at the default 1024 lanes and 64 windows all
// 65,536 threads are then resident at once, in one wave over 132 SMs.
__global__ void __launch_bounds__(128, 4) accumulate_kernel(uint32_t* __restrict__ buckets, const uint32_t* __restrict__ points,
                                  const int* __restrict__ digits, i64 S, i64 Lw, int wd, int B) {
  const i64 T = Lw * wd;
  for (i64 t = blockIdx.x * (i64)blockDim.x + threadIdx.x; t < T;
       t += (i64)gridDim.x * blockDim.x) {
    const i64 lane = t / wd;
    uint32_t* own = buckets + 24 * B * t;
    for (int b = 1; b < B; b++) pt_store(own + 24 * b, pt_identity());
    for (i64 s = 0; s < S; s++) {
      int d = digits[s * T + t];  // = digits[(s * Lw + lane) * wd + w]
      if (d == 0) continue;
      Pt p = pt_load(points + 24 * (s * Lw + lane));
      if (d < 0) {
        p.y = fe_neg<FQ>(p.y);
        d = -d;
      }
      pt_store(own + 24 * d, pt_add(pt_load(own + 24 * d), p));
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
    pt_store(out + slot, pt_add(pt_load(in + slot), q));
  }
}

// seg[(w * P + j) * 2 + 0] = sum_j, [... + 1] = total_j over buckets
// b = (j+1)L - 1 .. jL of window w: suffix += S_b (0 < b < B), then
// total += suffix for b > jL.
__global__ void fold_segments_kernel(uint32_t* __restrict__ seg, const uint32_t* __restrict__ merged,
                                     int wd, int B, int P, int L) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < wd * P; t += gridDim.x * blockDim.x) {
    const int w = t / P, j = t - w * P;
    Pt suffix = pt_identity();
    Pt total = pt_identity();
    for (int b = (j + 1) * L - 1; b >= j * L; b--) {
      if (b > 0 && b < B) suffix = pt_add(suffix, pt_load(merged + 24 * ((i64)w * B + b)));
      if (b > j * L) total = pt_add(total, suffix);
    }
    pt_store(seg + 48 * (i64)t, suffix);
    pt_store(seg + 48 * (i64)t + 24, total);
  }
}

// wsums[w] = sum_j total_j + L * sum_j j * sum_j = sum_b b * S_{w,b}.
__global__ void fold_combine_kernel(uint32_t* __restrict__ wsums, const uint32_t* __restrict__ seg,
                                    int wd, int P, int log_l) {
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < wd; w += gridDim.x * blockDim.x) {
    Pt u = pt_identity(), t = pt_identity(), r = pt_identity();
    for (int j = P - 1; j >= 0; j--) {
      const uint32_t* s = seg + 48 * ((i64)w * P + j);
      u = pt_add(u, pt_load(s));
      if (j > 0) t = pt_add(t, u);
      r = pt_add(r, pt_load(s + 24));
    }
    for (int i = 0; i < log_l; i++) t = pt_double(t);
    pt_store(wsums + 24 * w, pt_add(r, t));
  }
}

}  // namespace

ZK_EXPORT int zk_pip_digits(void* digits, const void* scalars, i64 n, i64 c, i64 windows,
                            i64 is_signed, void* stream) {
  if (c < 1 || c > 16 || windows < 1 || windows * c > 256 + c - 1 || (is_signed != 0 && is_signed != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  digits_kernel<<<zk_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (int*)digits, (const uint32_t*)scalars, n, (int)c, (int)windows, (int)is_signed);
  return (int)cudaGetLastError();
}

// buckets: (Lw * wd, B, 24) words.
ZK_EXPORT int zk_pip_accumulate(void* buckets, const void* points, const void* digits, i64 S, i64 Lw,
                                i64 wd, i64 B, void* stream) {
  if (S < 1 || Lw < 1 || wd < 1 || B < 2) return (int)cudaErrorInvalidValue;
  accumulate_kernel<<<zk_blocks(Lw * wd, 128), 128, 0, (cudaStream_t)stream>>>(
      (uint32_t*)buckets, (const uint32_t*)points, (const int*)digits, S, Lw, (int)wd, (int)B);
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

// merged: (wd, B, 24), one lane; seg: (wd, P, 2, 24) with P * L >= B, L a
// power of two.
ZK_EXPORT int zk_pip_fold_segments(void* seg, const void* merged, i64 wd, i64 B, i64 P, i64 L,
                                   void* stream) {
  if (wd < 1 || B < 2 || P < 1 || L < 1 || (L & (L - 1)) || P * L < B || (P - 1) * L >= B)
    return (int)cudaErrorInvalidValue;
  fold_segments_kernel<<<zk_blocks(wd * P, 64), 64, 0, (cudaStream_t)stream>>>(
      (uint32_t*)seg, (const uint32_t*)merged, (int)wd, (int)B, (int)P, (int)L);
  return (int)cudaGetLastError();
}

// seg: (wd, P, 2, 24); wsums: (wd, 24).
ZK_EXPORT int zk_pip_fold_combine(void* wsums, const void* seg, i64 wd, i64 P, i64 log_l,
                                  void* stream) {
  if (wd < 1 || P < 1 || log_l < 0 || log_l > 16) return (int)cudaErrorInvalidValue;
  fold_combine_kernel<<<zk_blocks(wd, 32), 32, 0, (cudaStream_t)stream>>>(
      (uint32_t*)wsums, (const uint32_t*)seg, (int)wd, (int)P, (int)log_l);
  return (int)cudaGetLastError();
}
