// Kernel C: BN254 G1 arithmetic (Jacobian, over Fq) and the commitment MSM.
//
// Replaces the TPU curve kernels of zkevm_tpu/ec: group.py add / double
// (complete add-2007-bl with doubling and identity cases, dbl-2009-l),
// group.py scalar_mul_scan (per-lane double-and-add; the SRS generator
// kzg/params.py _srs_chunk / _srs_gen), and the commitment MSMs psmsm.py
// msm_ps (k > 10) and msm.py msm / FixedBaseMSM (k <= 10), with
// pippenger.py _horner. Only affine results have to match the reference.
//
// A point is 24 words: x, y, z (8 words each, Montgomery Fq); z = 0 is the
// identity.
//
// Bound on the H100: every point operation is ~16 Montgomery products on
// 96-byte points, so all these kernels are bound by int32 multiplies, not
// bytes. The MSM is a bucket method with c-bit windows:
//   1. digits (one thread per scalar and window);
//   2. (digit, index) pairs sorted per window (torch.sort, outside);
//   3. bucket sums by a segmented reduction that is balanced whatever the
//      digit distribution: each thread adds at most CH consecutive sorted
//      points, writes runs that lie inside its chunk straight to their
//      bucket and passes the first and last run of the chunk (which may
//      continue in a neighbour) to the next level, CH/2 times shorter;
//   4. sum_b b * S_b per window, by running sums over segments of buckets
//      (one thread per segment) and a halving tree of point adds;
//   5. Horner across windows in one thread.
// Complete formulas everywhere, so zero scalars, identity bases and
// repeated bases (the doubling case) need no special path.

#include "curve.cuh"

using namespace zk;

namespace {

__global__ void g1_add_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
                              const uint32_t* __restrict__ q, i64 n) {
  for (i64 i = blockIdx.x * (i64)blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    pt_store(out + 24 * i, pt_add(pt_load(p + 24 * i), pt_load(q + 24 * i)));
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
      if ((s.w[bit >> 5] >> (bit & 31)) & 1u) acc = pt_add(acc, base);
      if (bit != 255) base = pt_double(base);
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
  const uint32_t* bases;  // (N, 24) when perm != nullptr
  const int* perm;        // (W, L) sorted order -> base index, level 1 only
  const uint32_t* in_pts; // (W, L, 24) partial sums, later levels
  const int* digits;      // (W, L) non-decreasing per window
  uint32_t* out_pts;      // (W, 2 * NC, 24)
  int* out_digits;        // (W, 2 * NC)
  uint32_t* buckets;      // (W, B, 24)
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
      if (d != 0) {
        const uint32_t* src = a.perm ? a.bases + 24 * (i64)a.perm[w * a.L + e]
                                     : a.in_pts + 24 * (w * a.L + e);
        acc = pt_add(acc, pt_load(src));
      }
    }
    emit(a, w, c, cur, acc, first, true);
  }
}

// seg_out[s][w] = sum over buckets b in segment s of b * S_{w,b}.
__global__ void msm_bucket_reduce_kernel(uint32_t* __restrict__ seg_out,
                                         const uint32_t* __restrict__ buckets, int windows, i64 B,
                                         int seg) {
  const i64 nseg = B / seg;
  const i64 total = nseg * windows;
  for (i64 t = blockIdx.x * (i64)blockDim.x + threadIdx.x; t < total;
       t += (i64)gridDim.x * blockDim.x) {
    i64 s = t / windows;
    i64 w = t - s * windows;
    i64 lo = s * seg;
    i64 bottom = lo > 1 ? lo : 1;
    Pt run = pt_identity();
    Pt tot = pt_identity();
    for (i64 b = lo + seg - 1; b >= bottom; b--) {
      run = pt_add(run, pt_load(buckets + 24 * (w * B + b)));
      tot = pt_add(tot, run);
    }
    // tot = sum (b - bottom + 1) S_b; add (bottom - 1) * sum S_b
    tot = pt_add(tot, pt_mul_small(run, (uint32_t)(bottom - 1)));
    pt_store(seg_out + 24 * t, tot);
  }
}

// out = sum_w 2^(c w) wsums[w], Horner from the top window.
__global__ void g1_horner_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ wsums,
                                 int windows, int c) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  Pt acc = pt_identity();
  for (int w = windows - 1; w >= 0; w--) {
    for (int i = 0; i < c; i++) acc = pt_double(acc);
    acc = pt_add(acc, pt_load(wsums + 24 * w));
  }
  pt_store(out, acc);
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

ZK_EXPORT int zk_msm_accumulate(const void* bases, const void* perm, const void* in_pts,
                                const void* digits, void* out_pts, void* out_digits, void* buckets,
                                i64 L, i64 B, i64 windows, i64 ch, i64 final_level, void* stream) {
  if (ch < 4 || L < 1) return (int)cudaErrorInvalidValue;
  AccumArgs a;
  a.bases = (const uint32_t*)bases;
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
  msm_accumulate_kernel<<<zk_blocks(a.NC * windows, 128), 128, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_msm_bucket_reduce(void* seg_out, const void* buckets, i64 windows, i64 B, i64 seg,
                                   void* stream) {
  if (seg < 1 || B % seg) return (int)cudaErrorInvalidValue;
  msm_bucket_reduce_kernel<<<zk_blocks((B / seg) * windows, 128), 128, 0, (cudaStream_t)stream>>>(
      (uint32_t*)seg_out, (const uint32_t*)buckets, (int)windows, B, (int)seg);
  return (int)cudaGetLastError();
}

ZK_EXPORT int zk_g1_horner(void* out, const void* wsums, i64 windows, i64 c, void* stream) {
  g1_horner_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)wsums,
                                                      (int)windows, (int)c);
  return (int)cudaGetLastError();
}
