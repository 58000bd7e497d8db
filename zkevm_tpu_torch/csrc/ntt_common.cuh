// Device code shared by the radix-2 NTT (kernel B, ntt.cu) and the
// four-step NTT (kernel I, ntt4.cu): element copies, bit reversal, powers of
// w from the table of w^j (j < n/2), and the radix-2 sub-transforms that
// both run in shared memory.
#pragma once

#include "field.cuh"

namespace zk {

__device__ __forceinline__ void copy_elem(uint32_t* dst, const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = s[0];
  d[1] = s[1];
}

__device__ __forceinline__ int bitrev(int i, int bits) {
  return bits ? (int)(__brev((unsigned)i) >> (32 - bits)) : 0;
}

// w^e for 0 <= e < 2^k from the table of w^j, j < 2^(k-1).
__device__ __forceinline__ Fe power(const uint32_t* tw, i64 e, int k) {
  const i64 half = 1LL << (k - 1);
  if (e < half) return fe_load(tw + 8 * e);
  return fe_neg<FR>(fe_load(tw + 8 * (e - half)));
}

// Twiddles of a sub-transform's stage s, butterfly j: w^(j * 2^(k - s)) read
// from the device table of the 2^k-th root ...
struct DeviceTwiddles {
  const uint32_t* tw;
  int k;
  __device__ __forceinline__ Fe operator()(int j, int s) const { return fe_load(tw + 8 * ((i64)j << (k - s))); }
};

// ... or v^(j * 2^(m - s)) from a copy in shared memory of the table of
// v^j, j < 2^(m-1), v the 2^m-th root (the same values).
struct SharedTwiddles {
  const uint32_t* tw;
  int m;
  __device__ __forceinline__ Fe operator()(int j, int s) const { return fe_load(tw + 8 * (j << (m - s))); }
};

// The stages of `count` size-2^logm radix-2 DIT transforms held one after
// another in shared memory, inputs in bit-reversed order, outputs natural.
template <class TW>
__device__ void sub_transforms_by(uint32_t* sh, const TW& tw, int logm, int count) {
  if (logm == 0) return;
  const int half_m = 1 << (logm - 1);
  const int total = count * half_m;
  for (int s = 1; s <= logm; s++) {
    const int half = 1 << (s - 1);
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int which = t >> (logm - 1);
      const int u = t & (half_m - 1);
      const int j = u & (half - 1);
      const int i0 = (which << logm) + ((u >> (s - 1)) << s) + j;
      const int i1 = i0 + half;
      Fe x0 = fe_load(sh + 8 * i0);
      Fe x1 = fe_mul<FR>(tw(j, s), fe_load(sh + 8 * i1));
      fe_store(sh + 8 * i0, fe_add<FR>(x0, x1));
      fe_store(sh + 8 * i1, fe_sub<FR>(x0, x1));
    }
    __syncthreads();
  }
}

// Kernel I's form: butterfly j of stage s takes w^(j * 2^(k - s)) from the
// device table.
__device__ __forceinline__ void sub_transforms(uint32_t* sh, const uint32_t* __restrict__ tw, int k,
                                               int logm, int count) {
  sub_transforms_by<DeviceTwiddles>(sh, DeviceTwiddles{tw, k}, logm, count);
}

}  // namespace zk
