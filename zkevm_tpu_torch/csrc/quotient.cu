// Kernel M: one n-point part of the quotient's numerator.
//
// Replaces the TPU program of zkevm_tpu/plonk/prover.py _h_part (one
// jax.jit per extended-coset part over every constraint tree, plonk/expr.py
// Expr.evaluate with EvalContext): every constraint evaluated at every row
// of the part and folded by powers of y, h = h * y + v per scalar
// constraint and per lane of a vector one.
//
// The constraints arrive as a register program compiled on the host
// (zkevm_tpu_torch/plonk/quotient.py): four int32 words an instruction
// (op, dst, a, b). One thread per row (a grid-stride loop over rows) runs
// the whole program; a vector constraint's lanes are a loop inside the
// thread. The program is the same for every thread, so every branch of the
// opcode switch is uniform across a warp, and its words are read through
// the read-only cache as warp-wide broadcasts (device memory, not
// __constant__, so its length has no 64 KB cap).
//
// Bound on the H100: a part reads every column of part_vals once and
// writes the (n, 8) result, and issues 264 multiply instructions per
// product and 24 per addition of each distinct node once per row (once per
// lane below a group query). On the quotient's constraint sets the
// operations bound it. Design: intermediate values never reach device
// memory: they live in a per-thread register file in the block's shared
// memory (the host allocates registers by last use; KeccakTable's program
// peaks at 9 live values, 36 KB a block of 128 threads; the wrapper
// refuses a program of more than 56), laid out register-major and
// thread-minor in 16-byte halves, so a warp's access to one register is
// 512 contiguous bytes without bank conflicts. A rotation
// reads row (r + rot) mod n in place and a rolled group query reads its
// lane's member column from a pre-rolled index list: no copy of a column
// is ever made. Column offsets are 64-bit (part_vals exceeds 2^31 words).
// The product is field.cuh's, inlined into the two cases that use it (a
// called copy ran slower here, scripts/probe_quotient.py --alt times both;
// so did asynchronous loads, fused opcodes and the last result kept in
// registers, timed in turns against this kernel).

#include "field.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 128;

enum Op {
  OP_COL = 0,
  OP_GROUP = 1,
  OP_CONST = 2,
  OP_X = 3,
  OP_ADD = 4,
  OP_SUB = 5,
  OP_NEG = 6,
  OP_MUL = 7,
  OP_FOLD = 8,
  OP_LANES = 9,
  OP_END_LANES = 10,
  OP_END = 11,
};

// The thread's register file in the block's shared memory: (registers, 2,
// kThreads) halves of 16 bytes.
struct Regs {
  uint4* base;

  __device__ __forceinline__ Fe load(int r) const {
    const uint4* p = base + 2 * r * kThreads;
    uint4 lo = p[0], hi = p[kThreads];
    Fe x;
    x.w[0] = lo.x; x.w[1] = lo.y; x.w[2] = lo.z; x.w[3] = lo.w;
    x.w[4] = hi.x; x.w[5] = hi.y; x.w[6] = hi.z; x.w[7] = hi.w;
    return x;
  }

  __device__ __forceinline__ void store(int r, const Fe& x) const {
    uint4* p = base + 2 * r * kThreads;
    p[0] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
    p[kThreads] = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
  }
};

__device__ __forceinline__ Fe load_ro(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 lo = __ldg(q), hi = __ldg(q + 1);
  Fe r;
  r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
  r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
  return r;
}

// vals: (C, n, 8) columns; xs: (n, 8) domain points; consts: (K, 8), row 0
// y; code: the program; members: rolled group column lists; out: (n, 8).
__global__ void __launch_bounds__(kThreads) quotient_kernel(
    uint32_t* __restrict__ out, const uint32_t* __restrict__ vals, const uint32_t* __restrict__ xs,
    const uint32_t* __restrict__ consts, const int4* __restrict__ code,
    const int* __restrict__ members, i64 n) {
  extern __shared__ uint4 smem[];
  const i64 stride = (i64)gridDim.x * kThreads;
  const Regs regs{smem + threadIdx.x};
  const Fe y = load_ro(consts);
  for (i64 row = blockIdx.x * (i64)kThreads + threadIdx.x; row < n; row += stride) {
    Fe h = fe_zero();
    int lane = 0, width = 0, loop_pc = 0;
    for (int pc = 0;; pc++) {
      const int4 ins = __ldg(code + pc);
      Fe v;
      switch (ins.x) {
        case OP_COL: {
          i64 r = row + ins.w;  // ins.w in [0, n)
          if (r >= n) r -= n;
          v = load_ro(vals + 8 * ((i64)ins.z * n + r));
          break;
        }
        case OP_GROUP: {
          i64 r = row + ins.w;
          if (r >= n) r -= n;
          const i64 col = __ldg(members + ins.z + lane);
          v = load_ro(vals + 8 * (col * n + r));
          break;
        }
        case OP_CONST: v = load_ro(consts + 8 * (i64)ins.z); break;
        case OP_X: v = load_ro(xs + 8 * row); break;
        case OP_ADD: v = fe_add<FR>(regs.load(ins.z), regs.load(ins.w)); break;
        case OP_SUB: v = fe_sub<FR>(regs.load(ins.z), regs.load(ins.w)); break;
        case OP_NEG: v = fe_neg<FR>(regs.load(ins.z)); break;
        case OP_MUL: v = fe_mul<FR>(regs.load(ins.z), regs.load(ins.w)); break;
        case OP_FOLD:
          h = fe_add<FR>(fe_mul<FR>(h, y), regs.load(ins.z));
          continue;
        case OP_LANES:
          width = ins.z;
          lane = 0;
          loop_pc = pc;
          continue;
        case OP_END_LANES:
          if (++lane < width) pc = loop_pc;
          continue;
        default:  // OP_END
          goto done;
      }
      regs.store(ins.y, v);
    }
  done:
    fe_store(out + 8 * row, h);
  }
}

}  // namespace

// n_regs: the program's registers (32 bytes each per thread, in shared
// memory: at most 56).
ZK_EXPORT int zk_quotient_part(void* out, const void* vals, const void* xs, const void* consts,
                               const void* code, const void* members, i64 n, i64 n_regs,
                               void* stream) {
  if (n == 0) return 0;
  const i64 smem_bytes = (n_regs > 0 ? n_regs : 1) * 32 * kThreads;
  if (n_regs < 0 || smem_bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(quotient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  quotient_kernel<<<zk_blocks(n, kThreads), kThreads, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)vals, (const uint32_t*)xs, (const uint32_t*)consts,
      (const int4*)code, (const int*)members, n);
  return (int)cudaGetLastError();
}
