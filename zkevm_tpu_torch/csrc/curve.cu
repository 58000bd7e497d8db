// Kernel C: BN254 G1 arithmetic (Jacobian, over Fq) and the commitment MSM.
//
// Replaces the TPU curve kernels of zkevm_tpu/ec: group.py add / double
// (complete add-2007-bl with doubling and identity cases, dbl-2009-l),
// group.py scalar_mul_scan (per-lane double-and-add; the SRS generator
// kzg/params.py _srs_chunk / _srs_gen), and the commitment MSMs psmsm.py
// msm_ps (k > 10) and msm.py msm / FixedBaseMSM (k <= 10), with
// pippenger.py _horner. Only affine results have to match the reference.
//
// Bound on the H100: every point operation is 7 to 16 Montgomery products,
// so all these kernels are bound by int32 multiplies, not bytes. The MSM is
// a bucket method with c-bit windows over affine bases (curve.cuh):
//   1. digits (one thread per scalar and window);
//   2. (digit, index) pairs sorted per window (torch.sort, outside);
//   3. bucket sums by a segmented reduction that is balanced whatever the
//      digit distribution: each thread adds at most CH consecutive sorted
//      points (mixed additions from the affine bases on the first level),
//      writes runs that lie inside its chunk straight to their bucket and
//      passes the first and last run of the chunk (which may continue in a
//      neighbour) to the next level, CH/2 times shorter;
//   4. sum_b b * S_b per window by a fold in levels of segments of L items,
//      every level on the device: one thread per (window, segment) keeps
//      running sums over its L items and hands L * (their sum) and their
//      weighted sum to the next level, L times shorter;
//   5. Horner across windows in one warp, which shares each formula's
//      independent products across its lanes.
// Every step adds in one fixed order and uses no atomics, so two runs give
// the same words.

#include "curve.cuh"

using namespace zk;

namespace {

__global__ void g1_add_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
                              const uint32_t* __restrict__ q, i64 n) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    pt_store(out + 24 * i, pt_add<Ptx>(pt_load(p + 24 * i), pt_load(q + 24 * i)));
  }
}

// out[i] = scalars[i] * bases[i * base_stride]; scalars in standard form.
__global__ void g1_scalar_mul_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ bases,
                                     i64 base_stride, const uint32_t* __restrict__ scalars, i64 n) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    Pt base = pt_load(bases + 24 * i * base_stride);
    Fe s = fe_load(scalars + 8 * i);
    Pt acc = pt_identity();
    for (int bit = 0; bit < 256; bit++) {
      if ((s.w[bit >> 5] >> (bit & 31)) & 1u) acc = pt_add<Ptx>(acc, base);
      if (bit != 255) base = pt_double<Ptx>(base);
    }
    pt_store(out + 24 * i, acc);
  }
}

// digits[w][i] = bits [w*c, w*c + c) of scalar i (standard form).
__global__ void msm_digits_kernel(int* __restrict__ digits, const uint32_t* __restrict__ scalars,
                                  i64 n, int c, int windows) {
  const i64 total = n * windows;
  for (i64 t = blockIdx.x * (i64)blockDim.x + threadIdx.x; t < total;
       t += (i64)gridDim.x * blockDim.x) {
    i64 w = t / n;
    i64 i = t - w * n;
    int start = (int)w * c;
    int word = start >> 5, off = start & 31;
    uint32_t v = scalars[8 * i + word] >> off;
    if (off + c > 32 && word + 1 < 8) v |= scalars[8 * i + word + 1] << (32 - off);
    digits[t] = (int)(v & ((1u << c) - 1u));
  }
}

struct AccumArgs {
  const uint32_t* affine; // (N, 16) affine bases, level 1 only
  const int* perm;        // (W, L) sorted order -> base index (~index: the base negated), level 1
  const uint32_t* in_pts; // (W, L, 24) partial sums, later levels
  const int* digits;      // (W, L) non-decreasing per window
  uint32_t* out_pts;      // (W, 2 * NC, 24)
  int* out_digits;        // (W, 2 * NC)
  uint32_t* buckets;      // (W, B, 24), filled with the identity
  i64 L, B, NC;
  int W, CH, final_level;
};

__device__ __forceinline__ void emit(const AccumArgs& a, i64 w, i64 c, int d, const Pt& acc,
                                     bool first, bool last) {
  if (a.final_level || (!first && !last)) {
    if (d != 0) pt_store(a.buckets + 24 * (w * a.B + d), acc);
    return;
  }
  i64 slot = w * 2 * a.NC + 2 * c + (first ? 0 : 1);
  pt_store(a.out_pts + 24 * slot, acc);
  a.out_digits[slot] = d;
  if (first && last) {
    pt_store(a.out_pts + 24 * (slot + 1), pt_identity());
    a.out_digits[slot + 1] = d;
  }
}

template <class F>
__global__ void msm_accumulate_kernel(AccumArgs a) {
  const i64 total = (i64)a.W * a.NC;
  for (i64 t = blockIdx.x * (i64)blockDim.x + threadIdx.x; t < total;
       t += (i64)gridDim.x * blockDim.x) {
    i64 w = t / a.NC;
    i64 c = t - w * a.NC;
    i64 start = c * a.CH;
    i64 end = start + a.CH < a.L ? start + a.CH : a.L;
    const int* dg = a.digits + w * a.L;
    int cur = dg[start];
    Pt acc = pt_identity();
    bool first = true;
    for (i64 e = start; e < end; e++) {
      int d = dg[e];
      if (d != cur) {
        emit(a, w, c, cur, acc, first, false);
        first = false;
        acc = pt_identity();
        cur = d;
      }
      if (d == 0) continue;
      if (a.perm) {
        int idx = a.perm[w * a.L + e];
        const bool neg = idx < 0;
        if (neg) idx = ~idx;
        const uint32_t* src = a.affine + 16 * (i64)idx;
        Fe y = fe_load(src + 8);
        if (neg) y = fq_neg<F>(y);
        acc = pt_madd<F>(acc, fe_load(src), y);
      } else {
        acc = pt_add<F>(acc, pt_load(a.in_pts + 24 * (w * a.L + e)));
      }
    }
    emit(a, w, c, cur, acc, first, true);
  }
}

// One level of the fold sum_b b * X_b over the m items of each window.
// Thread (w, j) takes items b = jL .. jL + L - 1 (past m: the identity;
// item 0 is never read, its weight being 0): from the top down, suffix +=
// X_b, then total += suffix for b > jL, so that suffix = S_j = sum X_b and
// total = sum (b - jL) X_b; on levels after the first total also adds the
// items' Y_b. It writes X'_j = L * S_j (log2 L doublings) and Y'_j = total,
// with sum_b b X_b + sum_b Y_b = sum_j j X'_j + sum_j Y'_j; with one segment
// left (final) it writes total, the window's sum, to out[w].
// in: (W, m, 24) without Y, (W, m, 2, 24) with; out: (W, P, 2, 24), or
// (W, 24) when final.
template <class F>
__global__ void msm_fold_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ in, int W,
                                i64 m, int L, int log_l, int has_y, int final_level) {
  const i64 P = (m + L - 1) / L;
  const int stride = has_y ? 48 : 24;
  for (i64 t = blockIdx.x * (i64)blockDim.x + threadIdx.x; t < (i64)W * P;
       t += (i64)gridDim.x * blockDim.x) {
    const i64 w = t / P, j = t - w * P;
    const uint32_t* items = in + (i64)stride * w * m;
    Pt suffix = pt_identity();
    Pt total = pt_identity();
    for (int r = L - 1; r >= 0; r--) {
      const i64 b = j * L + r;
      if (b > 0 && b < m) suffix = pt_add<F>(suffix, pt_load(items + stride * b));
      if (r > 0) total = pt_add<F>(total, suffix);
    }
    if (has_y) {
      for (int r = 0; r < L; r++) {
        const i64 b = j * L + r;
        if (b < m) total = pt_add<F>(total, pt_load(items + stride * b + 24));
      }
    }
    if (final_level) {
      pt_store(out + 24 * w, total);
    } else {
      for (int i = 0; i < log_l; i++) suffix = pt_double<F>(suffix);
      pt_store(out + 48 * t, suffix);
      pt_store(out + 48 * t + 24, total);
    }
  }
}

// out = sum_w 2^(c w) wsums[w], Horner from the top window, in one warp.
template <class F>
__global__ void g1_horner_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ wsums,
                                 int windows, int c) {
  if (blockIdx.x != 0) return;
  Pt acc = pt_identity();
  for (int w = windows - 1; w >= 0; w--) {
    for (int i = 0; i < c; i++) acc = pt_double_warp<F>(acc);
    acc = pt_add_warp<F>(acc, pt_load(wsums + 24 * w));
  }
  if (threadIdx.x == 0) pt_store(out, acc);
}

}  // namespace

ZK_EXPORT int zk_g1_add(void* out, const void* p, const void* q, i64 n, void* stream) {
  if (n == 0) return 0;
  g1_add_kernel<<<zk_blocks(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)p, (const uint32_t*)q, n);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_g1_scalar_mul(void* out, const void* bases, i64 base_stride, const void* scalars,
                               i64 n, void* stream) {
  if (n == 0) return 0;
  g1_scalar_mul_kernel<<<zk_blocks(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)bases, base_stride, (const uint32_t*)scalars, n);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_msm_digits(void* digits, const void* scalars, i64 n, i64 c, i64 windows,
                            void* stream) {
  if (c < 1 || c > 16 || windows * c < 256) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  msm_digits_kernel<<<zk_blocks(n * windows, 256), 256, 0, (cudaStream_t)stream>>>(
      (int*)digits, (const uint32_t*)scalars, n, (int)c, (int)windows);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_msm_accumulate(const void* affine, const void* perm, const void* in_pts,
                                const void* digits, void* out_pts, void* out_digits, void* buckets,
                                i64 L, i64 B, i64 windows, i64 ch, i64 final_level, void* stream) {
  if (ch < 4 || L < 1 || (perm == nullptr) == (in_pts == nullptr)) return (int)cudaErrorInvalidValue;
  AccumArgs a;
  a.affine = (const uint32_t*)affine;
  a.perm = (const int*)perm;
  a.in_pts = (const uint32_t*)in_pts;
  a.digits = (const int*)digits;
  a.out_pts = (uint32_t*)out_pts;
  a.out_digits = (int*)out_digits;
  a.buckets = (uint32_t*)buckets;
  a.L = L;
  a.B = B;
  a.NC = (L + ch - 1) / ch;
  a.W = (int)windows;
  a.CH = (int)ch;
  a.final_level = (int)final_level;
  const int blocks = zk_blocks(a.NC * windows, 128);
  msm_accumulate_kernel<Ptx><<<blocks, 128, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_msm_fold(void* out, const void* in, i64 windows, i64 m, i64 log_l, i64 has_y,
                          i64 final_level, void* stream) {
  if (windows < 1 || m < 1 || log_l < 1 || log_l > 8) return (int)cudaErrorInvalidValue;
  const int L = 1 << log_l;
  if (final_level != (m <= L)) return (int)cudaErrorInvalidValue;
  const i64 threads = windows * ((m + L - 1) / L);
  const int blocks = zk_blocks(threads, 64);
  msm_fold_kernel<Ptx><<<blocks, 64, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, (int)windows, m, L, (int)log_l, (int)has_y, (int)final_level);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_g1_horner(void* out, const void* wsums, i64 windows, i64 c, void* stream) {
  if (windows < 1 || c < 1) return (int)cudaErrorInvalidValue;
  g1_horner_kernel<Ptx><<<1, 32, 0, (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)wsums,
                                                            (int)windows, (int)c);
  return (int)cudaGetLastError();
}
