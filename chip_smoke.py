#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``zkevm_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines before the last line:

0. the card's name and power limit (``nvidia-smi``);
1. build of the hand-written kernels A-J, L and M from ``zkevm_tpu_torch/csrc``;
2. every kernel against its plain PyTorch version on the card, bit for bit,
   with timings and bounds (Poseidon E also against the golden model; kernel
   B's ntt, intt, coset_ntt and coset_intt with the coset shift and 1/n
   fused into its loads and stores, against the plain transform and its
   scalings, also at k = 25, through its three passes; the Pippenger MSM G, unsigned and signed, at 2^12 points with zero scalars,
   repeated, opposite and identity bases and scalars >= 2^255, and its wide
   windows (C's sorted accumulation) at c = 9 and 10; the opening's kernel H at 2^20; the
   four-step NTT I at k = 7, 9 and 12, and at k = 20 on one column and
   k = 22 in a batch of 4, also against kernel B; I's column and row
   passes as rank r of a world of 2 and 4 runs them, at k = 9, 12, 20
   and 22; the lazy-13 field J over 2^20 Fq and 2^16 Fr elements, every
   signed-scale tuple of the point formulas and op chains; L's point
   formulas over 2^16 lanes, its MSM at 2^12 (c = 4) and 2^14 (c = 16) on
   random and 0/1 scalars with its flag, the engine against C's MSM, its
   time by stage and launches per MSM, and the forced fallback of equal
   bases with equal scalars; the quotient
   evaluator M on the toy circuit's constraints at 2^12 rows);
3. the K=5 toy proofs, field by field against the reference proofs
   recorded in ``tests/vectors/torch_port_toy_proof.json``; then the small
   state-trie case (MPT circuit over the PoseidonTable, depth 8, k=12)
   against ``tests/vectors/torch_port_mpt.json``: kernel E against the
   reference's permute and hash_many, the witness digest, the MockProver's
   failure lists for the honest and four tampered witnesses, the verifying
   key and its fingerprint, and the proof under a PoseidonTranscript;
4. the first main path at full size: ``unsafe_setup(20)``, the KeccakTable
   circuit filled with messages made from ``--seed``, ``keygen``,
   ``create_proof``, ``verify_proof`` (True, and False on a tampered
   eval), with the kernels' launch counts over that path (M once per
   quotient part, no kernel-A launch and no ``torch.roll`` inside the
   quotient); then the proof again up to its first quotient part, and M on
   that whole part against the per-node path (one kernel-A launch per tree
   node) word for word and against its plain version on 512 rows (the
   first and last 64 among them);
5. the kernels again at the shapes that path gives them (the MSM over
   2^20 points, the per-lane scalar multiplication over 2^20 lanes, the
   batched NTT at k=20 and the quotient's transforms at its extended k,
   the per-node quotient path's (2^20, 64, 8) field broadcasts, which M
   replaced in the proof and the smoke still runs as M's cross-check, and
   B's fused coset transform of the quotient's first part on 2 columns and
   its coset_intt on one column at the extended k),
   each against its plain version bit for bit, timed beside its bound;
   the MSM's affine bases against the plain conversion, its result on
   all-zero scalars, its time by stage (digits, sort, accumulation, fold,
   Horner), and C,
   and G at c = 4 and 16, over the SRS with an identity base and equal and
   opposite bases against the golden sums on random, all-zero and 0/1
   scalars;
6. the second main path at full size: the state trie (MPT circuit over the
   PoseidonTable) at k=20 and trie depth 248: a trie of 16 entries and 32
   chained updates made from ``--seed``, ``poseidon_states``, the table and
   MPT assignment, ``MockProver.verify`` ([], and a failure on a forged
   root), ``unsafe_setup(20)``, ``keygen``, ``create_proof`` and
   ``verify_proof`` under a PoseidonTranscript (True, and False on a
   tampered eval), with its own launch counts; then M on its first quotient
   part as in phase 4;
7. kernels E and F again at the shapes that path gives them (the trace of
   every table slot, the zero test over the MockProver's largest row set);
8. the SRS-file path at k=20 on phase 6's circuit, assignment and seed:
   ``write_params_file`` of ``unsafe_setup(20)`` (phase 6's tau) into
   ``build/srs``, a few points of each section against the host goldens,
   ``load_params_file`` (whose engine is the Pippenger MSM G), ``keygen``
   (the vk fingerprint equals phase 6's), ``create_proof`` (every field
   equals phase 6's proof), ``verify_proof`` (True, and False on a tampered
   eval), ``open_single`` of a 2^20 column at a random z with
   ``verify_single`` (True, and False for value + 1), with the path's launch
   counts; then G over the loaded SRS at 2^20 points against its plain
   version word for word and against C's MSM by affine points (random,
   all-zero and 0/1 scalars), timed by stage;
9. the mesh path (``parallel/mesh.py``) over NCCL in a world of one GPU
   (a ``file://`` store under ``build/``): at 2^20 points ``sharded_msm``,
   ``sharded_msm_t_scan`` and ``sharded_msm_t`` (c = 4 and 16) against C's
   MSM by affine points and ``sharded_msm_t`` against G's MSM word for word,
   at 2^12 (c = 4) and 2^14 (c = 16, every fold segment) against its plain
   version; ``MeshMSM`` and G at c = 16 by stage, against C's MSM on
   all-zero and 0/1 scalars; ``sharded_ntt_batch`` (16 columns,
   k=20) against B and ``sharded_ntt_t`` (k = 20 and 22, both directions)
   against I word for word; then ``unsafe_setup(20)`` with ``use_mesh()``
   and phase 6's circuit: ``keygen`` (phase 6's vk fingerprint),
   ``create_proof`` (every field equals phase 6's proof), ``verify_proof``
   (True, and False on a tampered eval). Launches and collectives are
   counted in two windows: the mesh functions, then the proof. A world of one measures the local engine and NCCL's
   per-call cost, never scaling;
10. the l13 path (``ec/msm13.py``, kernels J and L) at k=20 on phase 6's
   circuit, assignment and seed: ``unsafe_setup(20, engine="l13")`` (phase
   6's tau; the SRS converted to affine lazy-13 once), ``keygen`` (phase 6's
   vk fingerprint), ``create_proof`` (every field equals phase 6's proof),
   ``verify_proof`` (True, and False on a tampered eval), with its launches
   (L > 0, C's MSM 0) and ``Msm13``'s calls and fallbacks (0); then L at
   2^20, c = 16, lanes 4096, window groups of 8 (the reference bench's MSM)
   against its plain version word for word (the plain version runs L's lane
   offsets, exclusive scans over groups of 8 level by level, where the
   reference's two blocked scans chain 129 additions; its default keeps the
   reference's words), and its own result against C's
   MSM on random and 0/1 scalars, with its time by stage and launches per
   MSM. L's boundary tree doubles where its inputs
   are equal (every boundary past a window's largest digit holds the window
   total), where the reference raises its doubling flag and falls back.

Then one JSON line with every kernel's numbers and, last, the ok line.
Any failure exits non-zero before the ok line. Without CUDA, or without
the package beside this script, it fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# 32-bit integer multiply(-add) instructions per second: 132 SMs x 64 INT32
# lanes x 1.98 GHz (the clock behind the data sheet's 67 TFLOP/s float32).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Multiply instructions (a low and a high half per word product) of one
# 8-word Montgomery product: 64 word products for a*b, 8 for the m_i, 64 for
# m*p. A squaring needs only the 36 distinct word products of a*a.
MUL_INT_OPS = 2 * 64 + 8 + 2 * 64
SQR_INT_OPS = 2 * 36 + 8 + 2 * 64
ADD_INT_OPS_FIELD = 24  # one field addition, subtraction or negation (three 8-word passes)
# G1 formulas in Jacobian coordinates, as products and squarings over Fq:
ADD_INT_OPS = 11 * MUL_INT_OPS + 5 * SQR_INT_OPS  # add-2007-bl, both inputs Jacobian
MADD_INT_OPS = 7 * MUL_INT_OPS + 4 * SQR_INT_OPS  # madd-2007-bl, second input affine
DBL_INT_OPS = 2 * MUL_INT_OPS + 5 * SQR_INT_OPS  # dbl-2009-l
# One Poseidon permutation (P128Pow5T3): 80 S-boxes (2 squarings and a
# product each) and 64 MDS applications of 9 products.
POSEIDON_INT_OPS = 160 * SQR_INT_OPS + 656 * MUL_INT_OPS
# The lazy-13 field (kernels J and L): one 32-bit multiply per limb product
# (441 for a product's columns, 231 for a square's) and, per term of a
# reduction, 42 x 164 u8 multiply-adds on the int8 tensor cores (1,979 T
# dense ops/s, two ops a multiply-add).
INT8_MACS_PER_S = 1979e12 / 2
L13_MUL, L13_SQR, L13_TERM_MACS = 441, 231, 42 * 164
# (multiplies, reduction terms) of ec/msm13.py's point formulas
L13_MADD = (7 * L13_MUL + 4 * L13_SQR, 15)
L13_ADD = (11 * L13_MUL + 5 * L13_SQR, 20)
L13_DBL = (2 * L13_MUL + 5 * L13_SQR, 9)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, int_ops: float, macs: float = 0) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate, 32-bit
    multiplies over the int32 rate or u8 multiply-adds over the int8
    tensor-core rate, the largest."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S, macs / INT8_MACS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of fn() in ms over reps calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Report:
    """Collects one record per kernel for the final JSON line."""

    SOURCES = {
        "field_mul": ("zkevm_tpu_torch/csrc/field.cu", "zkevm_tpu/ff/limbs.py:225"),
        "field_add_sub": ("zkevm_tpu_torch/csrc/field.cu", "zkevm_tpu/ff/limbs.py:192"),
        "field_pow": ("zkevm_tpu_torch/csrc/field.cu", "zkevm_tpu/ff/limbs.py:300"),
        "ntt": ("zkevm_tpu_torch/csrc/ntt.cu", "zkevm_tpu/poly/ntt.py:55"),
        "g1_add": ("zkevm_tpu_torch/csrc/curve.cu", "zkevm_tpu/ec/group.py:113"),
        "g1_scalar_mul": ("zkevm_tpu_torch/csrc/curve.cu", "zkevm_tpu/ec/group.py:177"),
        "msm": ("zkevm_tpu_torch/csrc/curve.cu", "zkevm_tpu/ec/psmsm.py:234"),
        "keccak": ("zkevm_tpu_torch/csrc/keccak.cu", "zkevm_tpu/hash/keccak.py:60"),
        "poseidon": ("zkevm_tpu_torch/csrc/poseidon.cu", "zkevm_tpu/hash/poseidon.py:191"),
        "field_nonzero": ("zkevm_tpu_torch/csrc/field.cu", "zkevm_tpu/plonk/mock.py:98"),
        "pippenger": ("zkevm_tpu_torch/csrc/pippenger.cu", "zkevm_tpu/ec/pippenger.py:213"),
        "kzg_open": ("zkevm_tpu_torch/csrc/kzg.cu", "zkevm_tpu/kzg/params.py:198"),
        "ntt4": ("zkevm_tpu_torch/csrc/ntt4.cu", "zkevm_tpu/poly/ntt.py:185"),
        "mesh": ("zkevm_tpu_torch/parallel/mesh.py", "zkevm_tpu/parallel/mesh.py:280"),
        "lazy13": ("zkevm_tpu_torch/csrc/lazy13.cu", "zkevm_tpu/ff/lazy13.py:436"),
        "msm13": ("zkevm_tpu_torch/csrc/msm13.cu", "zkevm_tpu/ec/msm13.py:340"),
        "quotient": ("zkevm_tpu_torch/csrc/quotient.cu", "zkevm_tpu/plonk/prover.py:443"),
    }

    def __init__(self):
        self.rows: dict[str, dict] = {}

    def record(self, name, shape, err, ms, plain_ms, nbytes, int_ops, library_ms=None, macs=0):
        b, by = bound(nbytes, int_ops, macs)
        src, rep = self.SOURCES[name]
        self.rows[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms, "shape": shape,
        }
        log(f"  {name:14s} {shape:34s} err={err} kernel={ms:.4f} ms plain={plain_ms:.2f} ms "
            f"bound={b:.4f} ms ({by})")


def _popcounts(torch, words):
    """Set bits of each (..., 8) int32 element (SWAR on int64)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((((x * 0x01010101) & 0xFFFFFFFF) >> 24)).sum(dim=-1)


def _bit_lengths(torch, words):
    """Bit length of each (..., 8) int32 element (0 for zero)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    per_word = sum(((x >> b) != 0).to(torch.int64) for b in range(32))
    offset = 32 * torch.arange(8, device=words.device)
    return torch.where(per_word > 0, offset + per_word, 0).max(dim=-1).values


def scalar_mul_int_ops(torch, scalars) -> int:
    """Multiply instructions of left-to-right double-and-add over these
    (n, 8) standard-form scalars from an affine base: per non-zero scalar,
    bit_length - 1 doublings and popcount - 1 mixed additions."""
    lengths = _bit_lengths(torch, scalars)
    nz = lengths > 0
    dbls = int((lengths - 1)[nz].sum().item())
    adds = int((_popcounts(torch, scalars) - 1)[nz].sum().item())
    return dbls * DBL_INT_OPS + adds * MADD_INT_OPS


def msm_int_ops(torch, scalars, c: int) -> int:
    """Multiply instructions of a c-bit-window bucket MSM over these (n, 8)
    standard-form scalars with affine bases: a mixed addition for every
    non-zero digit after the first of its bucket, two full additions per
    bucket for the running sums, then c doublings and one full addition per
    window for Horner."""
    w = scalars.to(torch.int64) & 0xFFFFFFFF
    bits = torch.cat([w, torch.zeros_like(w[:, :1])], dim=1)  # room for the last window
    bucket_adds, windows = 0, 0
    for start in range(0, 256, c):
        word, off = divmod(start, 32)
        v = bits[:, word] >> off
        if off + c > 32:
            v = v | (bits[:, word + 1] << (32 - off))
        v = v & ((1 << c) - 1)
        filled = int((torch.bincount(v, minlength=1 << c)[1:] > 0).sum().item())
        bucket_adds += int((v != 0).sum().item()) - filled
        windows += 1
    running = 2 * windows * ((1 << c) - 1)
    horner_dbl, horner_add = (windows - 1) * c, windows - 1
    return (bucket_adds * MADD_INT_OPS + (running + horner_add) * ADD_INT_OPS
            + horner_dbl * DBL_INT_OPS)


def pippenger_int_ops(torch, scalars, c: int, signed: bool, sublanes: int = 1024) -> int:
    """Multiply instructions of kernel G's work on these (n, 8) scalars with
    affine bases: a mixed addition per non-zero digit after the first into
    its (lane, window, bucket), a full addition per further filled lane of
    each (window, bucket) group in the lane merge, two per bucket for the
    fold's running sums, and Horner's additions and doublings. Windows wider
    than LANE_MAX_C (unsigned) run C's sorted MSM, counted as msm_int_ops."""
    from zkevm_tpu_torch.ec import pippenger as pip

    if c > pip.LANE_MAX_C and not signed:
        return msm_int_ops(torch, scalars, c)
    digits = pip.digit_table(scalars, c, 256, signed).abs()
    wd, nb = digits.shape[1], pip.num_buckets(c, signed)
    lw = pip.lane_width(digits.shape[0], sublanes)
    lane = torch.arange(digits.shape[0], device=digits.device) % lw
    nonzero = int((digits != 0).sum().item())
    filled = groups = 0
    for w in range(wd):
        d = digits[:, w]
        filled += int((torch.bincount(lane * nb + d, minlength=lw * nb).reshape(lw, nb)[:, 1:] > 0)
                      .sum().item())
        groups += int((torch.bincount(d, minlength=nb)[1:] > 0).sum().item())
    full = filled - groups + 2 * (nb - 1) * wd + wd - 1
    dbls = (wd - 1) * c
    return (nonzero - filled) * MADD_INT_OPS + full * ADD_INT_OPS + dbls * DBL_INT_OPS


def msm13_tree_work(torch, scalars, c: int) -> tuple[int, int, int]:
    """(boundaries with no smaller digit, tree nodes with an identity input,
    tree nodes with equal inputs) of kernel L's MSM on these scalars: the
    first are the identity and the second a copy, no addition; the third a
    doubling. A boundary's prefix sum is fixed by its position in the
    window's sorted digits, a tree node's by its inputs' (identities drop
    out), so equal positions are equal points."""
    from zkevm_tpu_torch.ec import msm13 as m13

    sd = torch.sort(m13.digit_windows(scalars, c), dim=1).values.contiguous()
    B = 1 << c
    t = torch.arange(1, B, dtype=sd.dtype, device=sd.device).expand(sd.shape[0], B - 1).contiguous()
    ids = torch.searchsorted(sd, t) - 1  # -1: the identity
    neg = int((ids < 0).sum().item())
    m = 1
    while m < B - 1:
        m *= 2
    ids = torch.cat([ids, ids.new_full((ids.shape[0], m - (B - 1)), -1)], dim=1)
    ident = equal = 0
    while m > 1:
        m //= 2
        a, b = ids[:, :m], ids[:, m:2 * m]
        ident += int(((a < 0) | (b < 0)).sum().item())
        equal += int(((a == b) & (a >= 0)).sum().item())
        top = int(ids.max().item()) + 1
        _, fresh = torch.unique(a * top + b, return_inverse=True)
        ids = torch.where(a < 0, b, torch.where(b < 0, a, top + fresh))
    return neg, ident, equal


def msm13_work(torch, scalars, c: int, lanes: int = 4096, wgroup: int = 8) -> tuple[int, int, int]:
    """(bytes, 32-bit multiplies, u8 multiply-adds) of kernel L's MSM over
    these scalars: per window n mixed additions, Lw + A for the lane-offset
    scans, Lw for their combination, the B - 1 boundaries and the m - 1 tree
    nodes less those that need no addition or only a doubling on this data
    (``msm13_tree_work``), c + 1 additions and c doublings for (B - 1) Total
    - sum PS; the Horner's c doublings and one addition per window. Bytes:
    each base (168) and scalar (32) read once."""
    from zkevm_tpu_torch.ec import msm13 as m13

    n = scalars.shape[0]
    g = m13.geometry(n, c, lanes, wgroup)
    w = g["W"]
    neg, ident, equal = msm13_tree_work(torch, scalars, c)
    madds = w * n
    adds = w * (2 * g["Lw"] + g["A"] + g["B"] - 1 + g["m"] - 1 + c + 2) - neg - ident - equal
    dbls = 2 * w * c + equal
    muls = madds * L13_MADD[0] + adds * L13_ADD[0] + dbls * L13_DBL[0]
    macs = (madds * L13_MADD[1] + adds * L13_ADD[1] + dbls * L13_DBL[1]) * L13_TERM_MACS
    return 200 * n + 3 * 84, muls, macs


# one Montgomery product per factor of f_i * w^i * d_i and of (f_i - f(z)) * d_i,
# an addition into the sum and a subtraction, per element
OPEN_INT_OPS = 3 * MUL_INT_OPS + 2 * ADD_INT_OPS_FIELD


def radix2_int_ops(k: int) -> int:
    """Multiply instructions of one radix-2 transform of 2^k: an addition and
    a subtraction for each of the k * n/2 butterflies, and a product for each
    butterfly whose twiddle is not w^0 = 1 (n/2 - n/2^s in stage s, so
    k * n/2 - (n - 1) in all)."""
    n = 1 << k
    return k * (n // 2) * 2 * ADD_INT_OPS_FIELD + (k * (n // 2) - (n - 1)) * MUL_INT_OPS


def ntt_t_int_ops(k: int, batch: int = 1, inverse: bool = False) -> int:
    """Multiply instructions of ntt_t over ``batch`` transforms of 2^k: the
    radix-2 sub-transforms (one of 2^k at k <= 7; 2^k2 of 2^k1 and 2^k1 of
    2^k2 above), the four-step twiddle's products (the elements off row and
    column 0), and the 1/n scaling of an inverse."""
    n = 1 << k
    if k >= 8:
        k1, k2 = k // 2, k - k // 2
        ops = (1 << k2) * radix2_int_ops(k1) + (1 << k1) * radix2_int_ops(k2)
        ops += ((1 << k1) - 1) * ((1 << k2) - 1) * MUL_INT_OPS
    else:
        ops = radix2_int_ops(k)
    if inverse:
        ops += n * MUL_INT_OPS
    return batch * ops


def max_abs_err(torch, a, b) -> int:
    """Largest absolute difference between two integer tensors (0 = equal)."""
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def plain_ms_of(torch, fn) -> tuple[object, float]:
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def ptxas_summary(log: str) -> dict:
    """{kernel: registers, stack, spill bytes} from nvcc's ``-Xptxas -v``
    output; a template kernel is named with its field arithmetic (Ptx)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled, parts, i = m.group(1), [], 3
            while mangled.startswith("_ZN") and i < len(mangled) and mangled[i].isdigit():
                j = i
                while mangled[j].isdigit():
                    j += 1
                parts.append(mangled[j : j + int(mangled[i:j])])
                i = j + int(mangled[i:j])
            policy = re.search(r"(?:zk|S_)\d+(Ptx)", mangled)
            name = (parts[-1] if parts else mangled) + (f"<{policy.group(1)}>" if policy else "")
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def stage_ms(torch, run, reps: int = 3) -> dict:
    """Mean device ms of each stage of an MSM over reps runs, after a
    warm-up: run(marks) appends (stage, CUDA event) after each stage."""
    run(None)
    torch.cuda.synchronize()
    totals: dict[str, float] = {}
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks: list = []
        run(marks)
        torch.cuda.synchronize()
        prev = start
        for name, ev in marks:
            totals[name] = totals.get(name, 0.0) + prev.elapsed_time(ev)
            prev = ev
    return {name: v / reps for name, v in totals.items()}


def msm13_split(torch, engine, scalars) -> dict:
    """Kernel L's stages on these scalars (``stage_ms`` over ``Msm13.raw``)
    and its launches in one MSM; logs both."""
    from zkevm_tpu_torch import kernels

    stages = stage_ms(torch, lambda marks: engine.raw(scalars, marks=marks))
    before = kernels.launch_counts()["msm13"]
    engine.raw(scalars)
    launches = kernels.launch_counts()["msm13"] - before
    log(f"  msm13 n={scalars.shape[0]} c={engine.c} by stage (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f"; {launches} launches an MSM")
    return {"stages_ms": stages, "launches_per_msm": launches}


def yardstick(torch, scalars) -> float:
    """The common yardstick of the commit engines: the bound of a c = 16
    bucket MSM (msm_int_ops) over these scalars, ms."""
    return bound(128 * scalars.shape[0], msm_int_ops(torch, scalars, 16))[0]


def edge_bases(torch, bases):
    """A copy of (n, 3, 8) bases with base 5 the identity, base 7 equal to
    base 6 and base 9 the opposite of base 8 (the affine conversion's and
    the mixed addition's edge cases), and the changed indices."""
    from zkevm_tpu_torch.ec import group

    out = bases.clone()
    out[5] = group.identity((), bases.device)
    out[7] = bases[6]
    out[9] = group.neg(bases[8:9])[0]
    return out, (5, 7, 9)


def edge_sum(torch, bases, edited, changed, scalars, base_sum):
    """sum_i s_i P'_i over the edited bases from sum_i s_i P_i over the
    original ones (an affine int point): add s_i (P'_i - P_i) for each
    changed index, on the host golden model."""
    from zkevm_tpu_torch.ec import goldens as g1g, group
    from zkevm_tpu_torch.ff import field as ff

    idx = list(changed)
    old = group.to_affine_ints(bases[idx])
    new = group.to_affine_ints(edited[idx])
    ks = ff.ints_from_words(scalars[idx])
    acc = base_sum
    for p_old, p_new, k in zip(old, new, ks):
        acc = g1g.add(acc, g1g.add(g1g.scalar_mul(p_new, k), g1g.neg(g1g.scalar_mul(p_old, k))))
    return acc


# ---------------------------------------------------------------------------
# composite kernels: launches and bounds over a main path
# ---------------------------------------------------------------------------

def _tree_ops(expr, width: int) -> int:
    """Multiply instructions of one evaluation of a constraint tree per row:
    each distinct node once (subtrees the tree shares are computed once),
    vector-valued nodes (below a group query) once per lane."""
    from zkevm_tpu_torch.plonk import expr as ex

    seen: dict[int, bool] = {}
    total = 0

    def walk(e) -> bool:
        nonlocal total
        if id(e) in seen:
            return seen[id(e)]
        if isinstance(e, ex.GroupQuery):
            vec = True
        elif isinstance(e, ex.Neg):
            vec = walk(e.inner)
            total += ADD_INT_OPS_FIELD * (width if vec else 1)
        elif isinstance(e, (ex.Sum, ex.Prod)):
            vec = walk(e.a) | walk(e.b)
            op = MUL_INT_OPS if isinstance(e, ex.Prod) else ADD_INT_OPS_FIELD
            total += op * (width if vec and width else 1)
        else:
            vec = False
        seen[id(e)] = vec
        return vec

    walk(expr)
    return total


class CompositeMeter:
    """While active, counts the kernel launches of the composite kernels
    (functions that compose A-C, as the reference composes its limb ops)
    and adds up, from each call's own inputs, the bytes they must move and
    the multiply instructions they must issue. A call made inside another
    composite counts towards the outer one.

    K6 ``Domain`` divide_by_vanishing_poly / coeff_to_extended /
    extended_to_coeff; K11 the grand products' ``prefix_product``; K12 the
    quotient's ``_h_part``; K13 ``eval_polys_at`` (its powers table
    included); K14 SHPLONK ``open_many`` (its MSMs included). Inside each it
    also counts the launches by kernel and the calls of ``torch.roll``."""

    KEYS = ("K6", "K11", "K12", "K13", "K14")

    def __init__(self, torch):
        self.torch = torch
        self.launches = {k: 0 for k in self.KEYS}
        self.nbytes = {k: 0 for k in self.KEYS}
        self.ops = {k: 0 for k in self.KEYS}
        self.calls = {k: 0 for k in self.KEYS}
        self.by_kernel = {k: {} for k in self.KEYS}
        self.rolls = {k: 0 for k in self.KEYS}
        self._active = None
        self._saved = []

    def _wrap(self, key, fn, cost):
        from zkevm_tpu_torch import kernels

        meter = self

        def wrapped(*args, **kwargs):
            if meter._active is not None:
                return fn(*args, **kwargs)
            meter._active = key
            before = kernels.launch_counts()
            try:
                out = fn(*args, **kwargs)
            finally:
                meter._active = None
            for name, count in kernels.launch_counts().items():
                if count > before[name]:
                    meter.launches[key] += count - before[name]
                    meter.by_kernel[key][name] = meter.by_kernel[key].get(name, 0) + count - before[name]
            nbytes, ops = cost(*args)
            meter.nbytes[key] += nbytes
            meter.ops[key] += ops
            meter.calls[key] += 1
            return out

        return wrapped

    def _patch(self, owner, name, key, cost):
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))
        setattr(owner, name, self._wrap(key, fn, cost))

    def __enter__(self):
        from zkevm_tpu_torch.ec import msm as msmmod, msm13 as m13, pippenger as pip
        from zkevm_tpu_torch.parallel import mesh as pm
        from zkevm_tpu_torch.plonk import prover as prv, shplonk
        from zkevm_tpu_torch.poly.domain import Domain

        torch = self.torch
        roll = torch.roll
        meter = self

        def counted_roll(*args, **kwargs):
            if meter._active is not None:
                meter.rolls[meter._active] += 1
            return roll(*args, **kwargs)

        self._saved.append((torch, "roll", roll))
        torch.roll = counted_roll

        def coset_ntt(dom, a):
            en = a.shape[-2]
            return 64 * en, radix2_int_ops(en.bit_length() - 1) + 2 * en * MUL_INT_OPS

        self._patch(Domain, "divide_by_vanishing_poly", "K6",
                    lambda dom, a: (64 * a.shape[0], a.shape[0] * MUL_INT_OPS))
        self._patch(Domain, "extended_to_coeff", "K6", coset_ntt)
        self._patch(Domain, "coeff_to_extended", "K6", coset_ntt)
        self._patch(prv, "prefix_product", "K11",
                    lambda spec, f: (64 * f.shape[0], (f.shape[0] - 1) * MUL_INT_OPS))

        def h_part_cost(protocol, cols_order, part_vals, domain_x, ch_mont, y):
            n = part_vals.shape[1]
            per_row = 0
            for con, width in protocol.constraints:
                per_row += _tree_ops(con, width)
                per_row += (width + 1) * MUL_INT_OPS + width * ADD_INT_OPS_FIELD if width else \
                    MUL_INT_OPS + ADD_INT_OPS_FIELD
            return 4 * part_vals.numel() + 32 * n, per_row * n

        self._patch(prv, "_h_part", "K12", h_part_cost)
        self._patch(prv, "eval_polys_at", "K13",
                    lambda c, x: (4 * c.numel(), c.shape[0] * c.shape[1] * (MUL_INT_OPS + ADD_INT_OPS_FIELD)
                                  + c.shape[1] * MUL_INT_OPS))

        def open_many_cost(params, domain, queries, transcript):
            polys = {id(q[1]): q[1] for q in queries}
            return sum(4 * t.numel() for t in polys.values()), 0

        self._patch(shplonk, "open_many", "K14", open_many_cost)

        def count_msm(engine_cls, ops_of):
            call = engine_cls.__call__

            def msm_call(engine, scalars):
                if meter._active == "K14":
                    meter.ops["K14"] += ops_of(engine, scalars)
                return call(engine, scalars)

            self._saved.append((engine_cls, "__call__", call))
            engine_cls.__call__ = msm_call

        # K14's two MSMs, by the params' engine: C's, G's (a loaded SRS file)
        # or the mesh's
        count_msm(msmmod.MSM, lambda e, sc: msm_int_ops(torch, sc, msmmod.window_bits(sc.shape[0])))
        count_msm(pip.PippengerMSM, lambda e, sc: pippenger_int_ops(torch, sc, e.c, False, e.sublanes))
        count_msm(pm.MeshMSM, lambda e, sc: scalar_mul_int_ops(torch, sc) if e.scan else
                  pippenger_int_ops(torch, sc, e.c, False, MESH_SUBLANES))
        count_msm(m13.Msm13, lambda e, sc: msm13_work(torch, sc, e.c, e.lanes, e.wgroup)[1])
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []
        return False

    def summary(self) -> dict:
        out = {}
        for k in self.KEYS:
            b, by = bound(self.nbytes[k], self.ops[k])
            out[k] = {"calls": self.calls[k], "launches": self.launches[k], "by_kernel": self.by_kernel[k],
                      "rolls": self.rolls[k], "bound_ms": b, "bound_by": by}
        return out

    def check_quotient(self, parts: int) -> None:
        """K12 ran ``parts`` quotient parts, each one launch of kernel M and
        nothing else: no other kernel and no ``torch.roll``."""
        got = (self.calls["K12"], self.by_kernel["K12"], self.rolls["K12"])
        if got != (parts, {"quotient": parts}, 0):
            raise AssertionError(f"quotient: {parts} parts should be {parts} launches of M and no roll; "
                                 f"got calls, launches by kernel, rolls = {got}")
        log(f"  quotient: {parts} parts, {parts} launches of M, no other launch and no torch.roll inside")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_field(torch, spec, n, gen, dev):
    """n canonical field elements (top word below p's), with 0, 1, p-1."""
    w = torch.randint(0, 1 << 32, (n, 8), generator=gen, dtype=torch.int64)
    top = (spec.modulus >> 224) & 0xFFFFFFFF
    w[:, 7] = w[:, 7] % top
    w = (w - ((w >> 31) << 32)).to(torch.int32)
    from zkevm_tpu_torch.ff import field as ff
    w[:3] = ff.to_tensor(ff.words_from_ints([0, 1, spec.modulus - 1]), "cpu")
    return w.to(dev)


def check_equal(what: str, err: int) -> None:
    if err != 0:
        raise AssertionError(f"{what}: kernel differs from the plain version (max abs err {err})")


def phase_field(torch, rep: Report, gen, dev, n: int) -> None:
    from zkevm_tpu_torch.ff import field as ff

    worst = {"field_mul": 0, "field_add_sub": 0, "field_pow": 0}
    times = {}
    for spec in (ff.FR, ff.FQ):
        a = random_field(torch, spec, n, gen, dev)
        b = random_field(torch, spec, n, gen, dev).flip(0).contiguous()
        cases = [
            ("field_mul", "mul", lambda: ff.mont_mul(spec, a, b), lambda: ff.PLAIN["mul"](spec, a, b)),
            ("field_mul", "sqr", lambda: ff.sqr(spec, a), lambda: ff.PLAIN["mul"](spec, a, a)),
            ("field_mul", "to_mont", lambda: ff.to_mont(spec, a),
             lambda: ff.PLAIN["mul"](spec, a, ff._raw(spec.r2, str(dev)))),
            ("field_mul", "from_mont", lambda: ff.from_mont(spec, a),
             lambda: ff.PLAIN["mul"](spec, a, ff._raw(1, str(dev)))),
            ("field_mul", "bcast", lambda: ff.mont_mul(spec, a.reshape(-1, 64, 8), b[:64]),
             lambda: ff.PLAIN["mul"](spec, a.reshape(-1, 64, 8), b[:64])),
            ("field_add_sub", "add", lambda: ff.add(spec, a, b), lambda: ff.PLAIN["add"](spec, a, b)),
            ("field_add_sub", "sub", lambda: ff.sub(spec, a, b), lambda: ff.PLAIN["sub"](spec, a, b)),
            ("field_add_sub", "neg", lambda: ff.neg(spec, a),
             lambda: ff.PLAIN["sub"](spec, torch.zeros_like(a), a)),
            ("field_pow", "inv", lambda: ff.inv(spec, a),
             lambda: ff.PLAIN["pow"](spec, a, spec.modulus - 2)),
        ]
        for kname, op, kern, plain in cases:
            got = kern()
            want, pms = plain_ms_of(torch, plain)
            err = max_abs_err(torch, got, want)
            check_equal(f"{spec.name} {op}", err)
            worst[kname] = max(worst[kname], err)
            if op in ("mul", "add", "inv") and spec.name == "Fr":
                times[kname] = (cuda_ms(torch, kern), pms)
        inv = ff.inv(spec, a)
        # a strided view (every other element), as the affine normalisation
        # of (n, 3, 8) points hands z in
        check_equal(f"{spec.name} inv of a strided view",
                    max_abs_err(torch, ff.inv(spec, a.reshape(-1, 2, 8)[:, 1]), inv.reshape(-1, 2, 8)[:, 1]))
        prod = ff.mont_mul(spec, a, inv)
        one = spec.mont_one(dev)
        ok = (prod[3:] == one).all() and (inv[0] == 0).all()
        if not bool(ok):
            raise AssertionError(f"{spec.name}: a * inv(a) != 1 or inv(0) != 0")
        log(f"  {spec.name}: mul sqr to_mont from_mont bcast add sub neg inv (and inv of a strided view) "
            f"equal on {n} elements")
    e = ff.FR.modulus - 2  # the timed inversion is over Fr: square-and-multiply
    pow_ops = (e.bit_length() - 1) * SQR_INT_OPS + (bin(e).count("1") - 1) * MUL_INT_OPS
    shape = f"({n}, 8) Fr"
    rep.record("field_mul", shape, worst["field_mul"], *times["field_mul"], 96 * n, MUL_INT_OPS * n)
    rep.record("field_add_sub", shape, worst["field_add_sub"], *times["field_add_sub"], 96 * n,
               ADD_INT_OPS_FIELD * n)
    rep.record("field_pow", shape, worst["field_pow"], *times["field_pow"], 64 * n, pow_ops * n)


def phase_ntt(torch, rep: Report, gen, dev, k_small: int = 16, k_full: int = 20) -> None:
    from zkevm_tpu_torch.ff import field as ff
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.poly import ntt as nt

    k = k_small
    a = random_field(torch, FR, 4 << k, gen, dev).reshape(4, 1 << k, 8)
    n_inv = FR.const(pow(1 << k, FR.modulus - 2, FR.modulus), dev)
    for name, kern in (("ntt", lambda: nt.ntt(a)), ("intt", lambda: nt.intt(a)),
                       ("coset_ntt", lambda: nt.coset_ntt(a, 7)), ("coset_intt", lambda: nt.coset_intt(a, 7))):
        got = kern()
        if name == "ntt":
            want = nt.PLAIN["fft"](a, k, nt._omega_powers(k, False, str(dev)))
        elif name == "intt":
            want = nt.PLAIN["fft"](a, k, nt._omega_powers(k, True, str(dev)))
            want = ff.PLAIN["mul"](FR, want, n_inv)
        elif name == "coset_ntt":
            scaled = ff.PLAIN["mul"](FR, a, plain_powers(torch, 7, 1 << k, dev))
            want = nt.PLAIN["fft"](scaled, k, nt._omega_powers(k, False, str(dev)))
        else:
            want = ff.PLAIN["mul"](FR, nt.PLAIN["fft"](a, k, nt._omega_powers(k, True, str(dev))), n_inv)
            want = ff.PLAIN["mul"](FR, want, plain_powers(torch, pow(7, FR.modulus - 2, FR.modulus), 1 << k, dev))
        check_equal(f"{name} k={k}", max_abs_err(torch, got, want))
    log(f"  ntt intt coset_ntt coset_intt (the shift and 1/n fused) equal at k={k}, batch 4")
    k = k_full
    x = random_field(torch, FR, 1 << k, gen, dev)
    if not torch.equal(nt.intt(nt.ntt(x)), x):
        raise AssertionError(f"intt(ntt(x)) != x at k={k}")
    tw = nt._omega_powers(k, False, str(dev))
    got = nt.ntt(x)
    want, pms = plain_ms_of(torch, lambda: nt.PLAIN["fft"](x, k, tw))
    err = max_abs_err(torch, got, want)
    check_equal(f"ntt k={k}", err)
    log(f"  ntt round trip and plain comparison equal at k={k}")
    ms = cuda_ms(torch, lambda: nt.ntt(x))
    n = 1 << k
    rep.record("ntt", f"({n}, 8) Fr, k={k}", err, ms, pms, 64 * n, radix2_int_ops(k))
    del x, got, want
    k = k_full + 5  # above 2^24 elements: B's three passes (fft_passes)
    x = random_field(torch, FR, 1 << k, gen, dev)
    got = nt.coset_ntt(x, 7)
    want = nt.PLAIN["fft"](ff.PLAIN["mul"](FR, x, plain_powers(torch, 7, 1 << k, dev)), k,
                           nt._omega_powers(k, False, str(dev)))
    check_equal(f"coset_ntt k={k}", max_abs_err(torch, got, want))
    if not torch.equal(nt.coset_intt(got, 7), x):
        raise AssertionError(f"coset_intt(coset_ntt(x)) != x at k={k}")
    del x, got, want
    nt._omega_powers.cache_clear()  # its 2^25 tables (1 GiB) would count in every later phase's peak
    log(f"  coset_ntt equal to the plain transform and coset_intt its inverse at k={k} ({len(nt.fft_passes(k))} "
        "passes)")


def phase_ntt4(torch, rep: Report, gen, dev, ks=(7, 9, 12), batch: int = 2) -> None:
    """Kernel I (ntt_t / intt_t) against its plain version and kernel B word
    for word: the one-pass branch (k = 7), an odd k (k1 != k2) and k = 12,
    in a batch; timed at k = 12 on one column."""
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.poly import ntt as nt

    for k in ks:
        a = random_field(torch, FR, batch << k, gen, dev).reshape(batch, 1 << k, 8)
        for inverse in (False, True):
            got = nt.ntt_t(a, k, inverse=inverse)
            check_equal(f"ntt_t k={k} inverse={inverse}",
                        max_abs_err(torch, got, nt.PLAIN["ntt_t"](a, k, inverse=inverse)))
            if not torch.equal(got, nt.intt(a, k) if inverse else nt.ntt(a, k)):
                raise AssertionError(f"ntt_t k={k} inverse={inverse} differs from kernel B")
    log(f"  ntt_t intt_t equal their plain versions and kernel B at k={list(ks)}, batch {batch}")
    k = ks[-1]
    n = 1 << k
    x = random_field(torch, FR, n, gen, dev)
    want, pms = plain_ms_of(torch, lambda: nt.PLAIN["ntt_t"](x, k))
    err = max_abs_err(torch, nt.ntt_t(x, k), want)
    check_equal(f"ntt_t k={k}", err)
    ms = cuda_ms(torch, lambda: nt.ntt_t(x, k))
    rep.record("ntt4", f"({n}, 8) Fr, k={k}", err, ms, pms, 64 * n, ntt_t_int_ops(k))


def phase_ntt4_layout(torch, gen, dev, ks=(9, 12, 20, 22), worlds=(2, 4)) -> None:
    """Kernel I's passes as sharded_ntt_t runs them on rank r of a world of
    2 or 4, on this one card: the column pass on the pitched slice of
    columns at c0 = r * n2 / world, the row pass reading the `world` blocks
    that the all_to_all leaves. Each pass is held to its plain version word
    for word, and the passes, with the all_to_all, gather and transpose done
    by hand, must give ntt_t."""
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.poly import ntt as nt

    for k in ks:
        k1, k2 = nt.fourstep_split(k)
        n1, n2 = 1 << k1, 1 << k2
        x = random_field(torch, FR, 1 << k, gen, dev)
        view = x.reshape(1, n1, n2, 8)
        for inverse in (False, True):
            want = nt.ntt_t(x, k, inverse=inverse)
            for world in worlds:
                w, m = n2 // world, n1 // world
                cols = []
                for r in range(world):
                    part = view[:, :, r * w : (r + 1) * w]
                    got = nt.ntt4_cols(part, k, c0=r * w, inverse=inverse)
                    check_equal(f"ntt4_cols k={k} inverse={inverse} rank {r} of {world}",
                                max_abs_err(torch, got, nt.PLAIN["ntt4_cols"](part, k, c0=r * w, inverse=inverse)))
                    cols.append(got.reshape(n1, w, 8))
                rows = []
                for r in range(world):
                    recv = torch.cat([b[r * m : (r + 1) * m] for b in cols])  # the all_to_all's blocks
                    got = nt.ntt4_rows(recv, k, k2, parts=world, inverse=inverse)
                    check_equal(f"ntt4_rows k={k} inverse={inverse} rank {r} of {world}",
                                max_abs_err(torch, got, nt.PLAIN["ntt4_rows"](recv, k, k2, parts=world,
                                                                               inverse=inverse)))
                    rows.append(got)
                out = nt.ntt4_transpose(torch.cat(rows).reshape(1, n1, n2, 8)).reshape(1 << k, 8)
                if not torch.equal(out, want):
                    raise AssertionError(f"ntt4 passes at world {world}, k={k}, inverse={inverse} differ from ntt_t")
        del x, view, want, cols, rows, out
    log(f"  ntt4_cols at c0 > 0 and ntt4_rows with parts = {list(worlds)} equal their plain versions, "
        f"and assemble ntt_t, at k={list(ks)}")


def phase_ntt4_shapes(torch, rep: Report, gen, dev, shapes=((20, 1), (22, 4))) -> None:
    """Kernel I at the main path's shapes (k = 20 on one column, as
    sharded_ntt_t runs it; k = 22 in a batch of 4, the reference bench's
    ntt_t): against its plain version and kernel B word for word, timed
    beside B."""
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.poly import ntt as nt

    extra = {}
    for k, batch in shapes:
        n = 1 << k
        a = random_field(torch, FR, batch * n, gen, dev).reshape(batch, n, 8)
        got = nt.ntt_t(a, k)
        want, pms = plain_ms_of(torch, lambda: nt.PLAIN["ntt_t"](a, k))
        check_equal(f"ntt_t k={k} batch {batch}", max_abs_err(torch, got, want))
        del want
        if not torch.equal(got, nt.ntt(a, k)) or not torch.equal(nt.intt_t(got, k), a):
            raise AssertionError(f"ntt_t k={k} batch {batch} differs from kernel B, or intt_t does not invert it")
        ms = cuda_ms(torch, lambda: nt.ntt_t(a, k))
        radix2_ms = cuda_ms(torch, lambda: nt.ntt(a, k))
        shape = f"({batch}, {n}, 8) Fr, k={k}"
        extra[k] = main_shape_entry("ntt4", shape, ms, pms / 1e3, "whole", 64 * batch * n,
                                    ntt_t_int_ops(k, batch))
        extra[k]["main_shape_radix2_ms"] = radix2_ms
        log(f"  ntt_t at {shape}: equal to its plain version and kernel B; B's ntt {radix2_ms:.4f} ms")
        del a, got
        torch.cuda.empty_cache()
    k_bench = shapes[-1][0]
    rep.rows["ntt4"].update(extra[k_bench])
    rep.rows["ntt4"]["other_shapes"] = [extra[k] for k, _ in shapes[:-1]]


def _random_points(torch, count, rng, dev):
    from zkevm_tpu_torch.ec import goldens as g1g, group

    pts = [g1g.random_point(rng) for _ in range(count)]
    return pts, group.from_affine_ints(pts, dev)


def _random_scalars(count, rng):
    from zkevm_tpu_torch.ff.goldens import FR_MOD

    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(count)]


def phase_curve(torch, rep: Report, rng, dev, m: int = 4096, lanes: int = 256,
                n_msm: int = 1 << 12) -> None:
    from zkevm_tpu_torch.ec import goldens as g1g, group, msm as msmmod
    from zkevm_tpu_torch.ff import field as ff

    # complete addition, with the identity / same / opposite cases
    _, p = _random_points(torch, m, rng, dev)
    _, q = _random_points(torch, m, rng, dev)
    q[0] = p[0]
    q[1] = group.neg(p[1:2])[0]
    q[2] = group.identity((), dev)
    p[3] = group.identity((), dev)
    got = group.add(p, q)
    want, pms = plain_ms_of(torch, lambda: group.PLAIN["add"](p, q))
    if group.to_affine_ints(got) != group.to_affine_ints(want):
        raise AssertionError("g1_add differs from the plain version")
    if group.to_affine_ints(got[:1]) != group.to_affine_ints(group.PLAIN["double"](p[:1])):
        raise AssertionError("g1_add(p, p) != double(p)")
    ms = cuda_ms(torch, lambda: group.add(p, q))
    rep.record("g1_add", f"({m}, 3, 8) Fq", 0, ms, pms, 3 * 96 * m, ADD_INT_OPS * m)

    # per-lane scalar multiplication
    _, bases = _random_points(torch, lanes, rng, dev)
    ks = _random_scalars(lanes, rng)
    ks[0], ks[1] = 0, 1
    sc = ff.to_tensor(ff.words_from_ints(ks), dev)
    got = group.scalar_mul(bases, sc)
    want, pms = plain_ms_of(torch, lambda: group.PLAIN["scalar_mul"](bases, sc))
    if group.to_affine_ints(got) != group.to_affine_ints(want):
        raise AssertionError("g1_scalar_mul differs from the plain version")
    ms = cuda_ms(torch, lambda: group.scalar_mul(bases, sc))
    rep.record("g1_scalar_mul", f"{lanes} lanes", 0, ms, pms, 128 * lanes,
               scalar_mul_int_ops(torch, sc))

    # MSM at n=64 against the host golden, edge cases included
    n = 64
    pts, bases = _random_points(torch, n, rng, dev)
    ks = _random_scalars(n, rng)
    ks[0] = 0  # zero scalar
    bases[1] = group.identity((), dev)  # identity base
    pts[1] = None
    bases[5] = bases[4]  # repeated base, same scalar: the doubling case
    pts[5] = pts[4]
    ks[5] = ks[4]
    bases[6] = bases[4]
    pts[6] = pts[4]
    got = msmmod.msm(bases, ff.to_tensor(ff.words_from_ints(ks), dev))
    if group.to_affine_ints(got)[0] != g1g.msm(pts, ks):
        raise AssertionError("msm differs from the host golden at n=64")
    log("  msm equals ec/goldens at n=64 (zero scalar, identity base, repeated bases)")

    # MSM at n_msm: random scalars, and 0/1 scalars (one crowded bucket)
    n = n_msm
    _, bases = _random_points(torch, n, rng, dev)
    table = msmmod.group.doubling_table(bases)
    sc = ff.to_tensor(ff.words_from_ints(_random_scalars(n, rng)), dev)
    bits = ff.to_tensor(ff.words_from_ints(list(rng.integers(0, 2, n))), dev)
    engine = msmmod.MSM(bases)
    for label, s in (("random", sc), ("0/1", bits)):
        got = engine(s)
        want, pms = plain_ms_of(torch, lambda: msmmod.plain_msm(bases, s, table))
        if group.to_affine_ints(got) != group.to_affine_ints(want):
            raise AssertionError(f"msm differs from the plain version at n={n} ({label} scalars)")
    log(f"  msm equals the plain version at n={n} (random and 0/1 scalars)")
    ms = cuda_ms(torch, lambda: msmmod.msm(bases, sc))
    rep.record("msm", f"n={n}, random scalars", 0, ms, pms, 128 * n,
               msm_int_ops(torch, sc, msmmod.window_bits(n)))


def phase_pippenger(torch, rep: Report, rng, dev, n: int = 1 << 12) -> None:
    """Kernel G, unsigned and signed at c = 4, against its plain version bit
    for bit: random 256-bit scalars (half of them >= 2^255), every
    seventeenth zero, 2^256 - 1 among them, bases repeated with equal and
    with other scalars, an identity base and opposite bases; then its wide
    windows (C's sorted accumulation) at c = 9 and signed c = 10."""
    from zkevm_tpu_torch.ec import group, msm as msmmod, pippenger as pip
    from zkevm_tpu_torch.ff import field as ff

    _, bases = _random_points(torch, n, rng, dev)
    ks = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    for i in range(0, n, 17):
        ks[i] = 0
    ks[3] = (1 << 256) - 1
    bases[5] = bases[4]
    ks[5] = ks[4]
    bases[7] = group.identity((), dev)  # the identity base: the affine sentinel (0, 0)
    bases[9] = group.neg(bases[8:9])[0]  # opposite bases with equal scalars
    ks[9] = ks[8]
    bases[100:140] = bases[99]
    sc = ff.to_tensor(ff.words_from_ints(ks), dev)
    timed = {}
    for signed in (False, True):
        got = pip.msm(bases, sc, signed=signed)
        want, pms = plain_ms_of(torch, lambda: pip.PLAIN["msm"](bases, sc, signed=signed))
        check_equal(f"pippenger msm (signed={signed})", max_abs_err(torch, got, want))
        timed[signed] = pms
    if group.to_affine_ints(got) != group.to_affine_ints(msmmod.msm(bases, sc)):
        raise AssertionError(f"pippenger msm differs from C's msm at n={n}")
    # windows wider than LANE_MAX_C: G's digits through C's sorted
    # accumulation, and a fold of several levels
    for c, signed in ((9, False), (10, True)):
        small = (bases[:64], sc[:64])
        check_equal(f"pippenger msm (c={c}, signed={signed}, segmented fold)",
                    max_abs_err(torch, pip.msm(*small, c=c, sublanes=4, signed=signed),
                                pip.PLAIN["msm"](*small, c=c, sublanes=4, signed=signed)))
    log(f"  pippenger msm (c=4, unsigned and signed) equals the plain version at n={n} "
        f"(zero scalars, scalars >= 2^255, repeated, opposite and identity bases) and C's msm; at n=64 "
        f"with c=9 and signed c=10 (the sorted accumulation) its plain version")
    ms = cuda_ms(torch, lambda: pip.msm(bases, sc))
    rep.record("pippenger", f"n={n}, c=4 unsigned", 0, ms, timed[False], 128 * n + 96,
               pippenger_int_ops(torch, sc, 4, False))
    rep.rows["pippenger"]["signed"] = {"ms": cuda_ms(torch, lambda: pip.msm(bases, sc, signed=True)),
                                       "plain_ms": timed[True]}


def phase_kzg_open(torch, rep: Report, gen, rng, dev, k: int = 20) -> None:
    """Kernel H at the opening's 2^20 shape against its plain version: the
    value f(z) and the quotient, for a random z and evaluations."""
    from zkevm_tpu_torch.ff import field as ff
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.ff.goldens import fr_root_of_unity
    from zkevm_tpu_torch.kzg import params as kp
    from zkevm_tpu_torch.poly import ntt as nt

    n = 1 << k
    f = random_field(torch, FR, n, gen, dev)
    z = int.from_bytes(rng.bytes(32), "little") % FR.modulus
    xs = nt.power_table(fr_root_of_unity(k), n, dev)
    d = ff.inv(FR, ff.sub(FR, xs, FR.const(z, dev)))
    scale = int.from_bytes(rng.bytes(32), "little") % FR.modulus
    fz, q = kp.open_quotient(f, xs, d, scale)
    (pfz, pq), pms = plain_ms_of(torch, lambda: kp.PLAIN["open_quotient"](f, xs, d, scale))
    err = max(max_abs_err(torch, fz, pfz), max_abs_err(torch, q, pq))
    check_equal("kzg open quotient", err)
    log(f"  kzg open (value and quotient) equals the plain version at n={n}")
    ms = cuda_ms(torch, lambda: kp.open_quotient(f, xs, d, scale))
    rep.record("kzg_open", f"({n}, 8) Fr", err, ms, pms, 128 * n + 32, OPEN_INT_OPS * n)


def random_lazy13(torch, ctx, n, gen, dev):
    """(21, n) int32 lazy-13 values: limbs 0..19 random 13-bit, limb 20 below
    8 (value < 2^263), with 0, 1 and p - 1, the largest value below 2^263
    and quasi-canonical limbs (2^13 + 2^6 - 1) among them."""
    from zkevm_tpu_torch.ff import lazy13 as lz

    a = torch.randint(0, 1 << 13, (lz.L13, n), generator=gen, dtype=torch.int32)
    a[20] = torch.randint(0, 8, (n,), generator=gen, dtype=torch.int32)
    a[:, :3] = ctx.tensor([0, 1, ctx.p - 1], "cpu")
    a[:20, 3], a[20, 3] = (1 << 13) - 1, 7
    a[:20, 4], a[20, 4] = (1 << 13) + (1 << 6) - 1, 6
    return a.to(dev)


def by_chunks(torch, fn, n: int, chunk: int = 1 << 16):
    """fn(slice) over [0, n) in chunks, concatenated on the last axis, with
    its seconds (the plain versions' memory grows with 441 x the batch)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = torch.cat([fn(slice(i, min(i + chunk, n))) for i in range(0, n, chunk)], dim=-1)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_lazy13(torch, rep: Report, gen, dev, n: int = 1 << 20, n_fr: int = 1 << 16, chain: int = 40) -> None:
    """Kernel J's entry points against their plain versions word for word:
    over n lazy Fq elements and n_fr lazy Fr elements (edge values among
    them), every signed-scale tuple of the point formulas, and op chains
    whose outputs are fed back as inputs."""
    from zkevm_tpu_torch.ff import lazy13 as lz

    P = lz.PLAIN
    scales = [(1,), (2,), (3,), (4,), (2, -2), (1, -8), (1, -1, -1), (2, -2, -2), (4, -4, -8)]
    timed = {}
    for ctx, m in ((lz.ctx_fq(), n), (lz.ctx_fr(), n_fr)):
        a = random_lazy13(torch, ctx, m, gen, dev)
        b = random_lazy13(torch, ctx, m, gen, dev).flip(1).contiguous()
        d = torch.where(torch.arange(m, device=dev) % 5 == 0, lz.sub13(ctx, a, a), a)  # zeros among them
        canon_in = lz.mul13(ctx, a, b)
        cases = [
            ("mul13", lambda: lz.mul13(ctx, a, b), lambda sl: P["mul"](ctx, a[:, sl], b[:, sl])),
            ("sqr13", lambda: lz.sqr13(ctx, a), lambda sl: P["sqr"](ctx, a[:, sl])),
            ("add13", lambda: lz.add13(ctx, a, b), lambda sl: P["add"](ctx, a[:, sl], b[:, sl])),
            ("sub13", lambda: lz.sub13(ctx, a, b), lambda sl: P["sub"](ctx, a[:, sl], b[:, sl])),
            ("canon13", lambda: lz.canon13(ctx, canon_in), lambda sl: P["canon"](ctx, canon_in[:, sl])),
            ("is_zero13", lambda: lz.is_zero13(ctx, d), lambda sl: P["is_zero"](ctx, d[:, sl])),
            ("prod_T", lambda: lz.prod_T(a, b), lambda sl: P["prod_T"](a[:, sl], b[:, sl])),
            ("sqr_T", lambda: lz.sqr_T(a), lambda sl: P["prod_T"](a[:, sl], a[:, sl])),
            ("to_words", lambda: lz.to_words(lz.canon13(ctx, canon_in)).T,
             lambda sl: P["to_words"](P["canon"](ctx, canon_in[:, sl])).T),
        ]
        words = lz.to_words(lz.canon13(ctx, a))
        cases.append(("from_words", lambda: lz.from_words(words), lambda sl: P["from_words"](words[sl])))
        for name, kern, plain in cases:
            got = kern()
            want, secs = by_chunks(torch, plain, m)
            check_equal(f"lazy13 {ctx.spec.name} {name}", max_abs_err(torch, got, want))
            if ctx is lz.ctx_fq() and name == "mul13":
                timed["mul13"] = (cuda_ms(torch, kern), secs * 1e3)
        if not bool(lz.is_zero13(ctx, lz.sub13(ctx, a, a)).all()) or bool(lz.is_zero13(ctx, a[:, 1:2]).any()):
            raise AssertionError(f"lazy13 {ctx.spec.name}: x - x is not zero, or 1 is")
        k = min(m, 1 << 16)
        for sc in scales:
            xs = [random_lazy13(torch, ctx, k, gen, dev) for _ in range(len(sc) + 1)]
            kt = [(lz.prod_T(xs[i], xs[i + 1]), s) for i, s in enumerate(sc)]
            check_equal(f"lazy13 {ctx.spec.name} combine_reduce {sc}",
                        max_abs_err(torch, lz.combine_reduce(ctx, kt), P["combine"](ctx, kt)))
        # chains: each op's output is the next op's input (invariants kept)
        x, y = a[:, :k].contiguous(), b[:, :k].contiguous()
        px, py = x.clone(), y.clone()
        for step in range(chain):
            op = step % 4
            if op == 0:
                x, px = lz.mul13(ctx, x, y), P["mul"](ctx, px, py)
            elif op == 1:
                x, px = lz.sub13(ctx, x, y), P["sub"](ctx, px, py)
            elif op == 2:
                y, py = lz.add13(ctx, x, y), P["add"](ctx, px, py)
            else:
                y, py = lz.combine_reduce(ctx, [(lz.prod_T(x, y), 4), (lz.sqr_T(x), -8)]), \
                    P["combine"](ctx, [(P["prod_T"](px, py), 4), (P["prod_T"](px, px), -8)])
        check_equal(f"lazy13 {ctx.spec.name} chain of {chain} ops",
                    max(max_abs_err(torch, x, px), max_abs_err(torch, y, py)))
        if int(x.max()) >= (1 << 13) + (1 << 6) or int(y.max()) >= (1 << 13) + (1 << 6):
            raise AssertionError(f"lazy13 {ctx.spec.name}: a chain left the quasi-canonical limb range")
        log(f"  lazy13 {ctx.spec.name}: mul13 sqr13 add13 sub13 canon13 is_zero13 prod_T sqr_T to_words "
            f"from_words equal the plain version on {m} elements (edges among them), combine_reduce for "
            f"the {len(scales)} scale tuples, a chain of {chain} ops")
    ms, pms = timed["mul13"]
    rep.record("lazy13", f"mul13 (21, {n}) Fq", 0, ms, pms, 3 * 84 * n, L13_MUL * n, macs=L13_TERM_MACS * n)
    rep.rows["lazy13"]["add13_ms"] = cuda_ms(torch, lambda: lz.add13(lz.ctx_fq(), a, b))


def phase_msm13(torch, rep: Report, rng, dev, lanes: int = 1 << 16,
                cases=((1 << 12, 4), (1 << 14, 16))) -> None:
    """Kernel L against its plain version word for word: madd_l, add_l and
    double_l over ``lanes`` lanes (identity, equal and opposite lanes among
    them); the MSM at 2^12 points, c = 4, and at 2^14, c = 16 (lanes 4096,
    window groups of 8) with zero scalars, r - 1 and repeated bases, its
    flag included (the plain version with L's lane offsets, ``lane_radix``),
    its time by stage and launches, and the engine (L's own result unless
    the flag fell back)
    against C's MSM by affine points, on random and on 0/1 scalars (whose
    boundary trees double nearly every node); the MSM at n = 12, 96 and 3904,
    c = 4, whose lanes a window are not a power of two, against the same
    two; the forced flag of equal bases with equal scalars."""
    from zkevm_tpu_torch.ec import group, msm as msmmod, msm13 as m13
    from zkevm_tpu_torch.ff import field as ff, lazy13 as lz
    from zkevm_tpu_torch.ff.goldens import FR_MOD
    from zkevm_tpu_torch.kzg import ParamsKZG

    ctx = lz.ctx_fq()
    pts = ParamsKZG.unsafe_setup(lanes.bit_length() - 1, device=dev).g1_powers  # distinct points
    ax, ay = m13.affine_l13(pts)
    one = torch.zeros_like(ax)
    one[0] = 1
    none = torch.zeros(lanes, dtype=torch.bool, device=dev)
    aff = m13.G1L(ax, ay, one, none)
    p = m13.double_l(aff)  # Jacobian, z != 1
    q = m13.G1L(torch.roll(ax, 1, 1), torch.roll(ay, 1, 1), one, none.clone())
    q = m13.add_l(q, m13.G1L(torch.roll(ax, 2, 1), torch.roll(ay, 2, 1), one, none))[0]
    inf = torch.arange(lanes, device=dev) % 97 == 0
    p = m13.G1L(p.x, p.y, p.z, inf)
    q.inf[5] = True
    for k in ("x", "y", "z"):
        getattr(q, k)[:, 7] = getattr(p, k)[:, 7]  # the same point
    q.y[:, 9] = lz.sub13(ctx, torch.zeros_like(p.y[:, 9:10]), p.y[:, 9:10])[:, 0]  # its negation
    for k in ("x", "z"):
        getattr(q, k)[:, 9] = getattr(p, k)[:, 9]
    pl, ql = m13._flat_pt(p), m13._flat_pt(q)
    # madd_l's leaf is affine: lane 13 of its accumulator is that leaf (z = 1)
    pm = m13.G1L(*(c.clone() for c in (p.x, p.y, p.z)), p.inf)
    pm.x[:, 13], pm.y[:, 13], pm.z[:, 13] = q.x[:, 13], q.y[:, 13], one[:, 13]
    pml = m13._flat_pt(pm)

    def same_words(got, want):
        return max([max_abs_err(torch, getattr(got, k), getattr(want, k)) for k in ("x", "y", "z")]
                   + [int((got.inf != want.inf).sum().item())])

    r, f_add = m13.add_l(p, q)
    (rp, fp), add_pms = plain_ms_of(torch, lambda: m13.PLAIN["add_l"](pl, ql))
    check_equal(f"msm13 add_l on {lanes} lanes", same_words(r, rp) + abs(f_add - int(fp)))
    r, f_madd = m13.madd_l(pm, q.x, q.y)
    rp, fp = m13.PLAIN["madd_l"](pml, ql.x, ql.y)
    check_equal(f"msm13 madd_l on {lanes} lanes", same_words(r, rp) + abs(f_madd - int(fp)))
    check_equal(f"msm13 double_l on {lanes} lanes", same_words(m13.double_l(p), m13.PLAIN["double_l"](pl)))
    if (f_add, f_madd) != (1, 1):
        raise AssertionError(f"msm13: the equal lanes raised doubling flags {f_add}, {f_madd}")
    add_ms = cuda_ms(torch, lambda: m13.add_l(p, q))
    log(f"  msm13 add_l, madd_l and double_l equal the plain version on {lanes} lanes (identity, equal "
        f"and opposite lanes; flags too); add_l {add_ms:.4f} ms")

    timed = {}
    for n, c in cases:
        ks = _random_scalars(n, rng)
        ks[0], ks[1] = 0, FR_MOD - 1
        bases = pts[:n].clone()
        bases[3] = bases[2]  # repeated bases, with other scalars
        bases[11] = bases[10]
        engine = m13.Msm13(bases, c=c)
        c_msm = msmmod.MSM(bases)
        flags, ref_flags = [], []
        for label, sc in (("random", ff.to_tensor(ff.words_from_ints(ks), dev)),
                          ("0/1", ff.to_tensor(ff.words_from_ints(list(rng.integers(0, 2, n))), dev))):
            got, flag = engine.raw(sc)
            (want, wflag), pms = plain_ms_of(torch, lambda: m13.PLAIN["msm13"](engine.ax13, engine.ay13, sc, c,
                                                                               254, 4096, 8,
                                                                               lane_radix=m13.LANE_RADIX))
            check_equal(f"msm13 n={n} c={c} ({label} scalars)", same_words(got, want) + abs(flag - wflag))
            before = engine.fallbacks
            if group.to_affine_ints(engine(sc)[None]) != group.to_affine_ints(c_msm(sc)[None]) \
                    or engine.fallbacks - before != flag:
                raise AssertionError(f"Msm13 n={n} c={c} ({label} scalars) differs from C's msm, "
                                     "or its fallback was not counted")
            flags.append(flag)
            # the reference's lane offsets: their flag (the association decides which sums meet equal inputs)
            ref_flags.append(m13.PLAIN["msm13"](engine.ax13, engine.ay13, sc, c, 254, 4096, 8)[1])
            if label == "random":
                timed[(n, c)] = (cuda_ms(torch, lambda: engine.raw(sc), reps=3), pms, flag, msm13_work(torch, sc, c),
                                 msm13_split(torch, engine, sc))
        log(f"  msm13 n={n} c={c} equals its plain version word for word on random and 0/1 scalars (flags "
            f"{flags}; in the reference's order {ref_flags}); Msm13 equals C's msm on both (fallbacks "
            f"{engine.fallbacks})")
        timed[(n, c)][4]["flags_random_01"] = {"L": flags, "reference_order": ref_flags}
    # lanes a window that are not a power of two: groups of 6, 2 (n = 12), 8, 6, 2 (96) and 8, 8, 61 (3904)
    for n in (12, 96, 3904):
        engine = m13.Msm13(pts[:n].clone(), c=4)
        sc = ff.to_tensor(ff.words_from_ints(_random_scalars(n, rng)), dev)
        got, flag = engine.raw(sc)
        want, wflag = m13.PLAIN["msm13"](engine.ax13, engine.ay13, sc, 4, 254, 4096, 8, lane_radix=m13.LANE_RADIX)
        check_equal(f"msm13 n={n} c=4 (lanes {m13.lane_groups(n)})", same_words(got, want) + abs(flag - wflag))
        if flag or group.to_affine_ints(engine(sc)[None]) != group.to_affine_ints(msmmod.MSM(pts[:n])(sc)[None]):
            raise AssertionError(f"Msm13 n={n} c=4: flag {flag}, or it differs from C's msm")
    log("  msm13 n=12, 96, 3904 c=4 (lane groups not all of 8) equal the plain version word for word and C's msm")
    # the forced flag: every base equal, every scalar equal
    bases = pts[:1].expand(64, 3, 8).contiguous()
    sc = ff.to_tensor(ff.words_from_ints([_random_scalars(1, rng)[0]] * 64), dev)
    engine = m13.Msm13(bases, c=4, lanes=8)
    if m13.msm13(engine.ax13, engine.ay13, sc, c=4, lanes=8)[1] != 1:
        raise AssertionError("msm13: equal bases with equal scalars raised no doubling flag")
    forced = engine(sc)
    if engine.fallbacks != 1 or group.to_affine_ints(forced[None]) != group.to_affine_ints(msmmod.MSM(bases)(sc)):
        raise AssertionError("Msm13: the forced fallback was not counted or differs from C's msm")
    log("  msm13: equal bases with equal scalars raise the flag; Msm13 falls back, counts it, equals C's msm")
    (n4, c4), (n, c) = cases
    ms, pms, flag, work, split = timed[(n, c)]
    rep.record("msm13", f"msm13 n={n}, c={c}, lanes=4096, wgroup=8", 0, ms, pms, *work[:2], macs=work[2])
    rep.rows["msm13"].update({f"n{n}_c{c}_{k}": v for k, v in split.items()})
    b4, by4 = bound(*timed[(n4, c4)][3])
    rep.rows["msm13"].update({f"n{n4}_c{c4}_ms": timed[(n4, c4)][0], f"n{n4}_c{c4}_plain_ms": timed[(n4, c4)][1],
                              f"n{n4}_c{c4}_bound_ms": b4, f"n{n4}_c{c4}_bound_by": by4,
                              "add_l_ms": add_ms, "add_l_plain_ms": add_pms,
                              "flags": {f"n{n4}_c{c4}": timed[(n4, c4)][2], f"n{n}_c{c}": flag}})


def phase_keccak(torch, rep: Report, gen, dev, n: int = 4096) -> None:
    from zkevm_tpu_torch.hash import keccak as kk

    st = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 25), generator=gen, dtype=torch.int64).to(dev)
    got = kk.keccak_f(st)
    want, pms = plain_ms_of(torch, lambda: kk.PLAIN["keccak_f"](st))
    err = max_abs_err(torch, got, want)
    check_equal("keccak_f", err)
    digest = kk.keccak256(b"", dev).hex()
    if not digest.endswith("a470"):
        raise AssertionError(f"keccak256(b'') = {digest}")
    msgs = [bytes(range(256)) * (i % 70) + bytes([i % 256]) * (i % 137) for i in range(64)]
    blocks, nblk = kk._pack(msgs, dev)
    if not torch.equal(kk.sponge(blocks, nblk), kk.PLAIN["sponge"](blocks, nblk)):
        raise AssertionError("keccak sponge differs from the plain version")
    log(f"  keccak_f equal on {n} states; keccak256(b'') = ...{digest[-4:]}; sponge equal on 64 messages")
    ms = cuda_ms(torch, lambda: kk.keccak_f(st))
    rep.record("keccak", f"{n} states", err, ms, pms, 400 * n, 9200 * n)


def _encode_states(torch, rows, dev):
    """Lists of field ints -> (len(rows), width, 8) Montgomery tensor."""
    from zkevm_tpu_torch.ff import field as ff
    from zkevm_tpu_torch.ff.field import FR

    width = len(rows[0]) if rows else 3
    words = FR.encode_many([v for r in rows for v in r]).reshape(len(rows), width, 8)
    return ff.to_tensor(words, dev)


def phase_poseidon(torch, rep: Report, gen, dev, n: int = 1 << 14, n_golden: int = 64) -> None:
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.hash import poseidon as pos

    spec = pos.P128_POW5_T3
    p = FR.modulus
    st = random_field(torch, FR, 3 * n, gen, dev).reshape(n, 3, 8)
    st[:4] = _encode_states(torch, [[0, 1, p - 1], [0, 0, 0], [1, 1, 1], [p - 1] * 3], dev)
    got = pos.permute(spec, st)
    want, pms = plain_ms_of(torch, lambda: pos.PLAIN["permute"](spec, st))
    err = max_abs_err(torch, got, want)
    check_equal("poseidon permute", err)
    golden = [pos.permute_golden(spec, s) for s in
              (FR.decode_many(st[i]) for i in range(n_golden))]
    if [FR.decode_many(got[i]) for i in range(n_golden)] != golden:
        raise AssertionError("poseidon permute differs from permute_golden")
    tr = pos.permute_trace(spec, st)
    check_equal("poseidon trace", max_abs_err(torch, tr, pos.PLAIN["trace"](spec, st)))
    if not torch.equal(tr[:, :, -1].permute(1, 0, 2), got):
        raise AssertionError("poseidon trace does not end in the permutation's output")
    for length in (2, 5):
        msgs = random_field(torch, FR, n * length, gen, dev).reshape(n, length, 8)
        check_equal(f"poseidon hash_many L={length}",
                    max_abs_err(torch, pos.hash_many(spec, msgs), pos.PLAIN["hash_many"](spec, msgs)))
    log(f"  poseidon permute, trace and hash_many (L=2, 5) equal on {n} states; "
        f"permute equals permute_golden on {n_golden}")
    ms = cuda_ms(torch, lambda: pos.permute(spec, st))
    rep.record("poseidon", f"{n} states, permute", err, ms, pms, 192 * n, POSEIDON_INT_OPS * n)


def random_words_with_zeros(torch, shape, gen, dev):
    """(*shape, 8) int32 words: every third element zero, every seventh
    with one non-zero word, the rest random."""
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (*shape, 8), generator=gen, dtype=torch.int64)
    flat = x.view(-1, 8)
    flat[0::3] = 0
    flat[1::7] = 0
    flat[1::7, 5] = 1
    return x.to(torch.int32).to(dev)


def phase_nonzero(torch, rep: Report, gen, dev) -> None:
    from zkevm_tpu_torch.ff import field as ff

    timed = None
    for shape in ((1 << 20,), (1 << 16, 64)):
        x = random_words_with_zeros(torch, shape, gen, dev)
        got = ff.nonzero(x)
        want, pms = plain_ms_of(torch, lambda: ff.PLAIN["nonzero"](x))
        err = max_abs_err(torch, got, want)
        check_equal(f"nonzero {shape}", err)
        if timed is None:
            timed = (x, err, pms)
    log("  nonzero equal at (1048576, 8) and (65536, 64, 8)")
    x, err, pms = timed
    n = x.shape[0]
    ms = cuda_ms(torch, lambda: ff.nonzero(x))
    lib = cuda_ms(torch, lambda: (x != 0).any(-1))
    rep.record("field_nonzero", f"({n}, 8) words", err, ms, pms, 33 * n, 0, library_ms=lib)


def quotient_record(torch, prog, part_vals, domain_x, consts) -> tuple[float, float, str]:
    """(M's ms on the part, its bound in ms, what bounds it): each column of
    the part and the domain points read once, the result written once, and
    the program's products and additions on every row."""
    from zkevm_tpu_torch.plonk import quotient as q

    ms = cuda_ms(torch, lambda: q.evaluate(prog, part_vals, domain_x, consts), reps=3)
    b, by = bound(4 * (part_vals.numel() + domain_x.numel()) + 32 * part_vals.shape[1], prog.int_ops())
    return ms, b, by


def phase_quotient(torch, rep: Report, gen, dev, k: int = 12) -> None:
    """Kernel M on the toy circuit's constraints (its gate, lookup and
    permutation arguments) at 2^k rows of random columns, against its
    plain version on every row."""
    from zkevm_tpu_torch.circuits import toy
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.plonk import ConstraintSystem, quotient as q
    from zkevm_tpu_torch.plonk.protocol import build_protocol

    n = 1 << k
    cs, _ = toy.build_toy(ConstraintSystem)
    ints = [int.from_bytes(np.random.default_rng(k).bytes(31), "little") for _ in range(4)]
    prot = build_protocol(cs, n, *ints[:3])
    cols = q.queried_columns(prot.constraints)
    prog = q.compile_constraints(prot.constraints, cols, n)
    part_vals = random_field(torch, FR, len(cols) * n, gen, dev).reshape(len(cols), n, 8)
    domain_x = random_field(torch, FR, n, gen, dev)
    consts = q.constants_table(prog, ints[3], [], dev)
    got = q.evaluate(prog, part_vals, domain_x, consts)
    want, pms = plain_ms_of(torch, lambda: q.plain_evaluate(prog, part_vals, domain_x, consts))
    err = max_abs_err(torch, got, want)
    check_equal(f"quotient, toy constraints at {n} rows", err)
    log(f"  quotient program (toy): {prog.describe()}")
    ms, _, _ = quotient_record(torch, prog, part_vals, domain_x, consts)
    rep.record("quotient", f"toy constraints, {n} rows", err, ms, pms,
               4 * (part_vals.numel() + domain_x.numel()) + 32 * n, prog.int_ops())


class _PartCaptured(Exception):
    pass


def capture_part(prove) -> dict:
    """Run ``prove`` (a create_proof call) up to its first quotient part and
    return that part's inputs; the proof stops there."""
    from zkevm_tpu_torch.plonk import quotient as q

    h_part, got = q.h_part, {}

    def capture(protocol, cols_order, part_vals, domain_x, ch_mont, y):
        got.update(protocol=protocol, cols_order=cols_order, part_vals=part_vals, domain_x=domain_x,
                   ch_mont=ch_mont, y=y)
        raise _PartCaptured

    q.h_part = capture
    try:
        prove()
    except _PartCaptured:
        pass
    finally:
        q.h_part = h_part
    if not got:
        raise AssertionError("create_proof reached no quotient part")
    return got


def check_quotient_part(torch, rng, part: dict, sample: int = 512, edge: int = 64) -> dict:
    """Kernel M on one whole quotient part of a main path against the
    per-node path (``h_part_by_nodes``: kernel A per tree node, rolls and
    stacks) word for word, and against its plain version on ``sample``
    rows: the first and last ``edge`` rows, where rotations wrap, and
    random others. Returns M's record for that part."""
    from zkevm_tpu_torch.plonk import quotient as q

    pv, dx = part["part_vals"], part["domain_x"]
    n = pv.shape[1]
    prog = q.compile_constraints(part["protocol"].constraints, part["cols_order"], n)
    consts = q.constants_table(prog, part["y"], part["ch_mont"], pv.device)
    log(f"  quotient program: {prog.describe()}; part_vals {tuple(pv.shape)}")
    got = q.evaluate(prog, pv, dx, consts)
    want, nodes_ms = plain_ms_of(torch, lambda: q.h_part_by_nodes(
        part["protocol"], part["cols_order"], pv, dx, part["ch_mont"], part["y"]))
    check_equal(f"quotient part ({n} rows) against the per-node path", max_abs_err(torch, got, want))
    del want
    rows = np.concatenate([np.arange(edge), np.arange(n - edge, n),
                           rng.choice(np.arange(edge, n - edge), sample - 2 * edge, replace=False)])
    want, pms = plain_ms_of(torch, lambda: q.plain_evaluate(prog, pv, dx, consts, rows=rows))
    check_equal(f"quotient part on {sample} rows against the plain version",
                max_abs_err(torch, got[torch.from_numpy(rows).to(pv.device)], want))
    ms, b, by = quotient_record(torch, prog, pv, dx, consts)
    log(f"  quotient part: M {ms:.4f} ms, bound {b:.4f} ms ({by}); per-node path {nodes_ms:.2f} ms; "
        f"plain {pms / 1e3:.2f} s on {sample} rows; equal to both")
    return {"shape": f"({pv.shape[0]}, {n}, 8) part, {len(prog.code)} instructions, {prog.n_regs} registers",
            "ms": ms, "bound_ms": b, "bound_by": by, "plain_ms": pms, "plain_on": f"{sample} rows",
            "per_node_ms": nodes_ms, "max_abs_err": 0}


# ---------------------------------------------------------------------------
# phase 3: the toy proofs against the recorded reference proofs
# ---------------------------------------------------------------------------

def phase_toy(torch, dev) -> None:
    from zkevm_tpu_torch.circuits import toy
    from zkevm_tpu_torch.kzg import ParamsKZG
    from zkevm_tpu_torch.plonk import Assignment, ConstraintSystem, create_proof, keygen, verify_proof
    from zkevm_tpu_torch.plonk.prover import proof_to_json

    vec = json.loads((ROOT / "tests" / "vectors" / "torch_port_toy_proof.json").read_text())
    params = ParamsKZG.unsafe_setup(vec["k"], tau=vec["tau"], device=dev)
    for name in ("toy", "two_phase"):
        ref = vec[name]
        if name == "toy":
            cs, cols = toy.build_toy(ConstraintSystem)
            witness = toy.assign_toy(cs, cols, Assignment)
            fixed = toy.fixed_only(cs, witness, Assignment)
        else:
            cs, cols = toy.build_two_phase(ConstraintSystem)
            fixed, witness = toy.two_phase_witness(cs, cols, Assignment)
        pk = keygen(params, cs, fixed)
        got_vk = [[list(p) for p in pk.vk.fixed_commitments], [list(p) for p in pk.vk.sigma_commitments]]
        if got_vk != [ref["fixed_commitments"], ref["sigma_commitments"]]:
            raise AssertionError(f"{name}: verifying key differs from the reference")
        proof = create_proof(params, pk, ref["instances"], witness, seed=ref["seed"])
        got = proof_to_json(proof)
        bad = [f for f in got if got[f] != ref["proof"][f]]
        if bad:
            raise AssertionError(f"{name}: proof fields differ from the reference: {bad}")
        if not verify_proof(params, pk.vk, ref["instances"], proof):
            raise AssertionError(f"{name}: the port's verifier rejects the proof")
        log(f"  {name}: vk and all {len(got)} proof fields equal the reference; verified")


def copy_assignment(asg):
    from zkevm_tpu_torch.plonk import Assignment

    out = Assignment(asg.cs, asg.n)
    out.cols = {c: a.copy() for c, a in asg.cols.items()}
    return out


def phase_mpt_small(torch, dev) -> None:
    from zkevm_tpu_torch.circuits import mpt_circuit as mpt, mpt_small as ms, poseidon_table as pt
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.hash import poseidon as pos
    from zkevm_tpu_torch.kzg import ParamsKZG
    from zkevm_tpu_torch.plonk import (Assignment, ConstraintSystem, MockProver, create_proof, keygen,
                                       verify_proof)
    from zkevm_tpu_torch.plonk.prover import proof_to_json
    from zkevm_tpu_torch.prover import vk_fingerprint
    from zkevm_tpu_torch.state import ZkTrie
    from zkevm_tpu_torch.transcript import PoseidonTranscript

    vec = json.loads((ROOT / "tests" / "vectors" / "torch_port_mpt.json").read_text())
    spec = pos.P128_POW5_T3
    ref = vec["poseidon"]
    got = pos.permute(spec, _encode_states(torch, ref["states"], dev))
    if [FR.decode_many(s) for s in got] != ref["permute"]:
        raise AssertionError("kernel E's permute differs from the reference's")
    for length, msgs in ref["messages"].items():
        if FR.decode_many(pos.hash_many(spec, _encode_states(torch, msgs, dev))) != ref["hash_many"][length]:
            raise AssertionError(f"kernel E's hash_many (L={length}) differs from the reference's")
    log(f"  poseidon permute ({len(ref['states'])} states) and hash_many "
        f"(L={', '.join(ref['messages'])}) equal the reference's")

    cs, ptcfg, mcfg = ms.build(ConstraintSystem, pt, mpt)
    ups = ms.updates(ZkTrie, mpt)
    if [[u.root_old, u.root_new] for u in ups] != vec["roots"] or [u.kh for u in ups] != vec["key_hashes"]:
        raise AssertionError("trie roots or key hashes differ from the reference's")
    asg = Assignment(cs, ms.N)
    pt.assign(cs, ptcfg, ms.N, mpt.poseidon_states(ups, ms.DEPTH, device=dev), asg, device=dev)
    mpt.assign(cs, mcfg, ms.N, ups, asg, device=dev)
    if asg.digest() != vec["witness_digest"]:
        raise AssertionError("the MPT witness differs from the reference's")
    mock = {"honest": ms.failures_to_json(MockProver(cs, asg, device=dev).verify())}
    for name, tamper in ms.TAMPERS.items():
        bad = copy_assignment(asg)
        tamper(bad, mcfg, ms.DEPTH)
        mock[name] = ms.failures_to_json(MockProver(cs, bad, device=dev).verify())
    for name, want in vec["mock"].items():
        if mock[name] != want:
            raise AssertionError(f"MockProver on the {name} witness: {mock[name]} != reference {want}")
    log(f"  depth {ms.DEPTH}, k={ms.K}: witness digest and MockProver failure lists "
        f"({', '.join(f'{k}: {len(v)}' for k, v in mock.items())}) equal the reference's")

    params = ParamsKZG.unsafe_setup(ms.K, tau=vec["tau"], device=dev)
    pk = keygen(params, cs, asg)
    if [list(p) for p in pk.vk.fixed_commitments] != vec["fixed_commitments"]:
        raise AssertionError("MPT verifying key differs from the reference's")
    if vk_fingerprint(pk.vk) != vec["vk_fingerprint"]:
        raise AssertionError("MPT vk_fingerprint differs from the reference's")
    proof = create_proof(params, pk, [], asg, seed=vec["seed"], transcript=PoseidonTranscript())
    got = proof_to_json(proof)
    bad = [f for f in got if got[f] != vec["proof"][f]]
    if bad:
        raise AssertionError(f"MPT proof fields differ from the reference: {bad}")
    if not verify_proof(params, pk.vk, [], proof, transcript=PoseidonTranscript()):
        raise AssertionError("the port's verifier rejects the MPT proof")
    log(f"  vk, vk_fingerprint and all {len(got)} proof fields (PoseidonTranscript) equal "
        "the reference; verified")


# ---------------------------------------------------------------------------
# phase 4: the main path, KeccakTable at size k
# ---------------------------------------------------------------------------

MAIN_K = 20  # the reference's inner degree, the size users prove at
KECCAK_PATH_KERNELS = ("field_mul", "field_add_sub", "field_pow", "ntt", "g1_scalar_mul", "msm", "keccak",
                       "quotient")
RATE = 136
EDGE_LENGTHS = [0, 1, 135, 136, 137, 271, 272, 2000]


def keccak_messages(rng, nperm: int) -> list[bytes]:
    """Messages that fill exactly nperm permutations: the padding edges
    (135 / 136 bytes and their multiples), then lengths spread over
    0..2000 bytes."""
    lengths, used = [], 0
    for ln in EDGE_LENGTHS:
        if used + ln // RATE + 1 <= nperm:
            lengths.append(ln)
            used += ln // RATE + 1
    while used < nperm:
        left = nperm - used
        if left <= 14:
            ln = (left - 1) * RATE + int(rng.integers(0, 96))
        else:
            ln = int(rng.integers(0, 2001))
            if ln // RATE + 1 > left - 1:
                continue
        lengths.append(ln)
        used += ln // RATE + 1
    return [rng.bytes(ln) for ln in lengths]


def phase_main(torch, dev, seed: int) -> tuple[dict, object, object]:
    import copy

    from zkevm_tpu_torch import kernels
    from zkevm_tpu_torch.circuits import keccak_table as kt
    from zkevm_tpu_torch.circuits.tables import Challenges
    from zkevm_tpu_torch.hash import keccak as kk
    from zkevm_tpu_torch.kzg import ParamsKZG
    from zkevm_tpu_torch.plonk import ConstraintSystem, create_proof, keygen, verify_proof

    times = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        log(f"  {name}: {times[name]:.1f} s")
        return out

    rng = np.random.default_rng(seed)
    k = MAIN_K
    n = 1 << k
    cs = ConstraintSystem()
    cfg = kt.configure(cs, Challenges.configure(cs))
    nperm = kt.num_perms(cs, n)
    msgs = keccak_messages(rng, nperm)
    log(f"  KeccakTable k={k}: {len(cs.advice_columns)} advice, {len(cs.fixed_columns)} fixed "
        f"columns, degree {cs.gate_degree()}; {len(msgs)} messages, {nperm} permutations, "
        f"{sum(map(len, msgs))} bytes")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with CompositeMeter(torch) as meter:
        params = step("unsafe_setup", lambda: ParamsKZG.unsafe_setup(k, device=dev))
        wit = step("assign", lambda: kt.assign(cs, cfg, n, msgs))
        pk = step("keygen", lambda: keygen(params, cs, wit.asg))
        proof = step("create_proof", lambda: create_proof(params, pk, [], wit.witness_phases(), seed=seed))
        ok = step("verify_proof", lambda: verify_proof(params, pk.vk, [], proof))
    launches = kernels.launch_counts()
    log(f"  launches: {json.dumps(launches)}")
    log(f"  composites: {json.dumps(meter.summary())}")
    meter.check_quotient(pk.vk.domain.extended_n // pk.vk.domain.n)
    log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not ok:
        raise AssertionError("verify_proof rejected the KeccakTable proof")
    bad = copy.deepcopy(proof)
    bad.evals[0] = (bad.evals[0] + 1) % 21888242871839275222246405745257275088548364400416034343698204186575808495617
    if verify_proof(params, pk.vk, [], bad):
        raise AssertionError("verify_proof accepted a proof with a tampered eval")
    log("  proof verified; tampered eval rejected")
    # the circuit's host-computed digests against kernel D's keccak256
    final = [pi for pi in range(nperm) if wit.asg.cols[cfg.is_final][pi * kt.PERM, 0] != 0]
    want = kk.keccak256_batch(msgs, dev)
    got = np.stack([wit.digest_bytes[pi].astype(np.uint8) for pi in final[: len(msgs)]])
    if len(final) != len(msgs) or not np.array_equal(got, want):
        raise AssertionError("KeccakTable digests differ from keccak256 on the card")
    log(f"  {len(msgs)} table digests equal keccak256 on the card")
    missing = [name for name in KECCAK_PATH_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the KeccakTable path: {missing}")
    part = check_quotient_part(torch, rng, capture_part(
        lambda: create_proof(params, pk, [], wit.witness_phases(), seed=seed)))
    return ({"times": times, "launches": launches, "composites": meter.summary(), "quotient_part": part},
            params, pk.vk.domain)


# ---------------------------------------------------------------------------
# phase 5: the kernels at the main path's own shapes, against their plain
# versions. The plain versions need far more memory and time than the
# kernels, so where a shape is too large for them in one piece they run on
# slices (rows, lanes, or MSM chunks whose sums are added), and each slice
# is held to the same slice of the kernel's output of the full call.
# ---------------------------------------------------------------------------

def plain_powers(torch, base: int, count: int, dev):
    """(count, 8) Montgomery powers base^i by plain products only (each
    step doubles the table: t[m:2m] = t[:m] * base^m)."""
    from zkevm_tpu_torch.ff import field as ff
    from zkevm_tpu_torch.ff.field import FR

    out = FR.mont_one(dev)[None]
    while out.shape[0] < count:
        step = FR.const(pow(base, out.shape[0], FR.modulus), dev)
        out = torch.cat([out, ff.PLAIN["mul"](FR, out, step)])
    return out[:count]


def plain_sum_lanes(torch, a):
    """Plain field sum over dim 1 of (rows, w, 8) by a halving tree."""
    from zkevm_tpu_torch.ff import field as ff
    from zkevm_tpu_torch.ff.field import FR

    while a.shape[1] > 1:
        h = a.shape[1] // 2
        a = ff.PLAIN["add"](FR, a[:, :h], a[:, h:])
    return a[:, 0]


def check_by_rows(torch, what: str, got, plain, rows: int, chunk: int, dim: int = 0) -> float:
    """Hold got against plain(sl) for every slice sl of ``chunk`` rows of
    ``dim``; returns the plain version's seconds."""
    seconds = 0.0
    for r in range(0, rows, chunk):
        sl = slice(r, min(rows, r + chunk))
        want, ms = plain_ms_of(torch, lambda: plain(sl))
        seconds += ms / 1e3
        part = got[sl] if dim == 0 else got[:, sl]
        check_equal(f"{what}, rows {sl.start}..{sl.stop}", max_abs_err(torch, part, want))
    return seconds


def main_shape_entry(name, shape, ms, plain_s, plain_on, nbytes, int_ops, library_ms=None) -> dict:
    """The main-shape fields of a kernel's record (the kernel was held to
    its plain version there, bit for bit)."""
    b, by = bound(nbytes, int_ops)
    lib = "" if library_ms is None else f" library={library_ms:.4f} ms"
    log(f"  {name:14s} {shape:34s} kernel={ms:.4f} ms plain={plain_s:.2f} s ({plain_on}) "
        f"bound={b:.4f} ms ({by}){lib}")
    return dict(main_shape=shape, main_shape_max_abs_err=0, main_shape_ms=ms,
                main_shape_plain_ms=plain_s * 1e3, main_shape_plain_on=plain_on,
                main_shape_bound_ms=b, main_shape_bound_by=by, main_shape_library_ms=library_ms)


def phase_main_shapes(torch, rep: Report, gen, rng, dev, params, domain, *, width: int = 64,
                      batch: int = 16, row_chunk: int = 1 << 14, lanes_checked: int = 1 << 14,
                      msm_chunk: int = 1 << 18) -> None:
    from zkevm_tpu_torch.ec import goldens as g1g, group, msm as msmmod
    from zkevm_tpu_torch.ff.goldens import fr_root_of_unity
    from zkevm_tpu_torch.ff import field as ff
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.poly import ntt as nt

    n, k = params.n, params.k
    main = {}

    def record(name, *args):
        main[name] = main_shape_entry(name, *args)

    # -- field broadcasts of the per-node quotient path (M's cross-check in
    # phases 4 and 6): (n, W, 8) vector-gate values
    # against a scalar column (n, 1, 8), the y-power fold (W, 8), a
    # constant (8,), a rotated copy, the lane sum, and the coset scaling
    # of the column stack (B, n, 8) x (n, 8)
    g = random_field(torch, FR, n * width, gen, dev).reshape(n, width, 8)
    g_rot = torch.roll(g, -1, dims=0)
    col = random_field(torch, FR, n, gen, dev)
    colv = col[:, None, :]
    ypows = random_field(torch, FR, width, gen, dev)
    const = random_field(torch, FR, 4, gen, dev)[3]
    mul, add, sub = ff.PLAIN["mul"], ff.PLAIN["add"], ff.PLAIN["sub"]
    cases = [
        ("mul (n,W)x(n,W) rotated", lambda: ff.mont_mul(FR, g, g_rot), lambda sl: mul(FR, g[sl], g_rot[sl])),
        ("mul (n,W)x(n,1)", lambda: ff.mont_mul(FR, g, colv), lambda sl: mul(FR, g[sl], colv[sl])),
        ("mul (n,W)x(W)", lambda: ff.mont_mul(FR, g, ypows), lambda sl: mul(FR, g[sl], ypows)),
        ("mul (n,W)x()", lambda: ff.mont_mul(FR, g, const), lambda sl: mul(FR, g[sl], const)),
        ("add (n,W)+(n,1)", lambda: ff.add(FR, g, colv), lambda sl: add(FR, g[sl], colv[sl])),
        ("sub (n,1)-(n,W)", lambda: ff.sub(FR, colv, g), lambda sl: sub(FR, colv[sl], g[sl])),
        ("neg (n,W)", lambda: ff.neg(FR, g), lambda sl: sub(FR, torch.zeros_like(g[sl]), g[sl])),
        ("sum_rows over W", lambda: ff.sum_rows(FR, g, dim=1), lambda sl: plain_sum_lanes(torch, g[sl])),
    ]
    plain_s = {}
    for what, kern, plain in cases:
        got = kern()
        plain_s[what] = check_by_rows(torch, what, got, plain, n, row_chunk)
        del got
    log(f"  field ops equal on the quotient's layouts at ({n}, {width}, 8): "
        + ", ".join(c[0] for c in cases))
    nel = n * width
    in_rows = f"all rows, {row_chunk} at a time"
    record("field_mul", f"({n}, {width}, 8) x ({n}, 1, 8) Fr",
           cuda_ms(torch, lambda: ff.mont_mul(FR, g, colv), reps=3), plain_s["mul (n,W)x(n,1)"],
           in_rows, 64 * nel + 32 * n, MUL_INT_OPS * nel)
    record("field_add_sub", f"({n}, {width}, 8) + ({n}, 1, 8) Fr",
           cuda_ms(torch, lambda: ff.add(FR, g, colv), reps=3), plain_s["add (n,W)+(n,1)"],
           in_rows, 64 * nel + 32 * n, ADD_INT_OPS_FIELD * nel)
    del g, g_rot
    big = random_field(torch, FR, batch * n, gen, dev).reshape(batch, n, 8)
    got = ff.mont_mul(FR, big, col)
    check_by_rows(torch, "mul (B,n)x(n)", got, lambda sl: mul(FR, big[:, sl], col[sl]), n,
                  row_chunk * width // batch, dim=1)
    del got
    log(f"  mul ({batch}, {n}, 8) x ({n}, 8) equal")

    # -- NTT: the batched base-domain transform of the quotient's parts and
    # its twiddles (a prefix product of kernel A), then the quotient's
    # division by the vanishing polynomial and its inverse coset transform
    # on the extended domain
    tw = plain_powers(torch, fr_root_of_unity(k), n // 2, dev)
    check_equal(f"twiddles k={k}", max_abs_err(torch, nt._omega_powers(k, False, str(dev)), tw))
    got = nt.ntt(big, k)
    want, pms = plain_ms_of(torch, lambda: nt.PLAIN["fft"](big, k, tw))
    check_equal(f"ntt ({batch}, {n}) batch", max_abs_err(torch, got, want))
    del got, want
    record("ntt", f"({batch}, {n}, 8) Fr, k={k}", cuda_ms(torch, lambda: nt.ntt(big, k), reps=3),
           pms / 1e3, "whole", 64 * batch * n, batch * radix2_int_ops(k))
    # the quotient's coset transform of its first part (shift g), its powers
    # fused into B's loads, on 2 columns against the plain scaling and fft
    two = big[:2].contiguous()
    del big
    shift = domain.g_coset
    got = nt.coset_ntt(two, shift)
    want, pms = plain_ms_of(torch, lambda: nt.PLAIN["fft"](mul(FR, two, plain_powers(torch, shift, n, dev)), k, tw))
    check_equal(f"coset_ntt (2, {n}) batch", max_abs_err(torch, got, want))
    del got, want
    main["ntt"].update(
        coset_2_columns_ms=cuda_ms(torch, lambda: nt.coset_ntt(two, shift), reps=5),
        coset_2_columns_bound_ms=bound(64 * 2 * n + 32 * n, 2 * (radix2_int_ops(k) + n * MUL_INT_OPS))[0],
        coset_2_columns_plain_ms=pms)
    del two
    ek, en = domain.extended_k, domain.extended_n
    h_ext = random_field(torch, FR, en, gen, dev)
    got_div = domain.divide_by_vanishing_poly(h_ext)
    period = en // n
    zh = domain.zh_inv_period(dev)
    want = mul(FR, h_ext.reshape(n, period, 8), zh).reshape(en, 8)
    check_equal(f"divide_by_vanishing_poly k={ek}", max_abs_err(torch, got_div, want))
    del h_ext, want
    got = domain.extended_to_coeff(got_div)
    shift_inv = pow(domain.g_coset, FR.modulus - 2, FR.modulus)
    omega_inv = pow(domain.extended_omega, FR.modulus - 2, FR.modulus)
    coset = plain_powers(torch, shift_inv, en, dev)
    check_equal(f"coset powers k={ek}", max_abs_err(torch, nt.power_table(shift_inv, en, dev), coset))

    def plain_extended_to_coeff():
        a = nt.PLAIN["fft"](got_div, ek, plain_powers(torch, omega_inv, en // 2, dev))
        a = mul(FR, a, FR.const(pow(en, FR.modulus - 2, FR.modulus), dev))
        return mul(FR, a, coset)

    want, pms = plain_ms_of(torch, plain_extended_to_coeff)
    check_equal(f"extended_to_coeff k={ek}", max_abs_err(torch, got, want))
    # coset_intt at the extended k, one column: the inverse transform with
    # shift^-i / n fused into B's stores
    main["ntt"].update(
        coset_intt_extended_shape=f"({en}, 8) Fr, k={ek}",
        coset_intt_extended_ms=cuda_ms(torch, lambda: domain.extended_to_coeff(got_div), reps=3),
        coset_intt_extended_bound_ms=bound(96 * en, radix2_int_ops(ek) + en * MUL_INT_OPS)[0],
        coset_intt_extended_plain_ms=pms)
    del got, got_div, want, coset
    log(f"  twiddles, ntt ({batch}, {n}, 8), coset_ntt (2, {n}, 8), divide_by_vanishing_poly and "
        f"extended_to_coeff (k={ek}, coset_intt) equal; plain extended_to_coeff {pms / 1e3:.2f} s; "
        + json.dumps({key: v for key, v in main["ntt"].items() if key.startswith("coset")}))

    # -- per-lane scalar multiplication with one base over all n lanes (the
    # SRS), held on lanes_checked lanes (0, 1 and r - 1 among them)
    gen_pt = group.from_affine_ints([g1g.G1_GEN], dev)[0]  # the SRS's base
    sc = random_field(torch, FR, n, gen, dev)
    got = group.scalar_mul(gen_pt, sc)
    idx = torch.cat([torch.arange(3), torch.from_numpy(
        rng.choice(np.arange(3, n), lanes_checked - 3, replace=False))]).to(dev)
    want, pms = plain_ms_of(torch, lambda: group.PLAIN["scalar_mul"](gen_pt, sc[idx]))
    if group.to_affine_ints(got[idx]) != group.to_affine_ints(want):
        raise AssertionError(f"g1_scalar_mul differs from the plain version at {n} lanes")
    del got, want
    log(f"  g1_scalar_mul over {n} lanes equals the plain version on {lanes_checked} of them")
    record("g1_scalar_mul", f"{n} lanes, one base",
           cuda_ms(torch, lambda: group.scalar_mul(gen_pt, sc), reps=2),
           pms / 1e3, f"{lanes_checked} of the lanes", 96 + 32 * n + 96 * n,
           scalar_mul_int_ops(torch, sc))

    # -- g1_add at the first level of the halving tree over n lanes (the
    # mesh's sharded_msm sums its per-lane products so), held on
    # lanes_checked of the n / 2 pairs
    pa, pb = params.g1_powers[: n // 2], params.g1_powers[n // 2 :]
    got = group.add(pa, pb)
    idx = torch.from_numpy(rng.choice(n // 2, lanes_checked, replace=False)).to(dev)
    if group.to_affine_ints(got[idx]) != group.to_affine_ints(group.PLAIN["add"](pa[idx], pb[idx])):
        raise AssertionError(f"g1_add differs from the plain version at ({n // 2}, 3, 8)")
    del got
    log(f"  g1_add equal at ({n // 2}, 3, 8) on {lanes_checked} of the pairs")

    # -- the commit MSM over the SRS: random scalars and 0/1 scalars (one
    # crowded bucket per window); the plain version sums over msm_chunk-point
    # chunks so that its doubling table fits
    bits = (torch.rand(n, generator=gen) < 0.5).to(torch.int32)
    bits = torch.nn.functional.pad(bits[:, None], (0, 7)).to(dev)
    scalars = {"random": sc, "0/1": bits}
    got = {key: params.committer(s) for key, s in scalars.items()}
    want = {key: group.identity((), dev) for key in scalars}
    seconds = {"table": 0.0, "random": 0.0, "0/1": 0.0}
    for start in range(0, n, msm_chunk):
        sl = slice(start, start + msm_chunk)
        table, ms = plain_ms_of(torch, lambda: group.doubling_table(params.g1_powers[sl]))
        seconds["table"] += ms / 1e3
        for key, s in scalars.items():
            part, ms = plain_ms_of(torch, lambda: msmmod.plain_msm(params.g1_powers[sl], s[sl], table))
            seconds[key] += ms / 1e3
            want[key] = group.PLAIN["add"](want[key], part)
        del table
    for key in scalars:
        if group.to_affine_ints(got[key]) != group.to_affine_ints(want[key]):
            raise AssertionError(f"msm differs from the plain version at n={n} ({key} scalars)")
    log(f"  msm equals the plain version at n={n} (random and 0/1 scalars; plain seconds "
        + json.dumps({key: round(v, 1) for key, v in seconds.items()}) + ")")
    engine = params.committer
    zero = torch.zeros_like(sc)
    if group.to_affine_ints(engine(zero)) != [None]:
        raise AssertionError(f"msm of all-zero scalars at n={n} is not the identity")
    # the affine conversion of unsafe_setup's bases (z != 1), against the
    # plain conversion on lanes_checked of them
    if not torch.equal(engine.affine[idx], group.PLAIN["to_affine"](params.g1_powers[idx])):
        raise AssertionError(f"to_affine of the SRS differs from the plain version on {lanes_checked} bases")
    msm_ms = cuda_ms(torch, lambda: engine(sc), reps=3)
    stages = stage_ms(torch, lambda marks: engine(sc, marks=marks))
    log(f"  msm at n={n}: {msm_ms:.4f} ms; stages " + json.dumps({s_: round(v, 4) for s_, v in stages.items()}))
    # edge cases over the 2^20 unsafe_setup bases: an identity base, equal
    # and opposite bases; C, and G at c = 4 and 16 over the same bases,
    # against the golden sum on random, all-zero and 0/1 scalars
    from zkevm_tpu_torch.ec import pippenger as pip

    edited, changed = edge_bases(torch, params.g1_powers)
    c_edge = msmmod.MSM(edited)
    g_affine = group.to_affine(edited)
    for key, s_ in (("random", sc), ("zero", zero), ("0/1", bits)):
        base_sum = None if key == "zero" else group.to_affine_ints(got[key])[0]
        want_edge = edge_sum(torch, params.g1_powers, edited, changed, s_, base_sum)
        results = {"C": c_edge(s_), "G c=4": pip.msm_affine(g_affine, s_, c=4),
                   "G c=16": pip.msm_affine(g_affine, s_, c=16, sublanes=128)}
        for label, res in results.items():
            if group.to_affine_ints(res) != [want_edge]:
                raise AssertionError(f"{label} over the edge bases at n={n} ({key} scalars) differs from the "
                                     "golden sum")
    del c_edge, g_affine, edited
    log(f"  msm, pippenger c=4 and c=16 over the 2^20 SRS with an identity base, equal and opposite bases: "
        "equal to the golden sums on random, all-zero and 0/1 scalars")
    record("msm", f"n={n}, random scalars", msm_ms,
           seconds["table"] + seconds["random"], f"{n // msm_chunk} chunks of {msm_chunk} points",
           128 * n, msm_int_ops(torch, sc, msmmod.window_bits(n)))
    main["msm"].update(main_shape_stages_ms=stages, main_shape_yardstick_ms=yardstick(torch, sc))

    for name, row in main.items():
        rep.rows[name].update(row)


# ---------------------------------------------------------------------------
# phase 6: the second main path, the state trie (MPT circuit over the
# PoseidonTable) at size k and trie depth MPT_DEPTH
# ---------------------------------------------------------------------------

MPT_DEPTH = 248  # the reference's trie depth (state/zktrie.py)
SETUP_TAU = 0xDEAD_BEEF_CAFE  # unsafe_setup's default tau
MPT_PREFILL = 16
MPT_UPDATES = 32  # 16 inserts and 16 updates: 16,000 of the 16,131 table slots at k=20
MPT_PATH_KERNELS = ("field_mul", "field_add_sub", "field_pow", "field_nonzero", "ntt",
                    "g1_scalar_mul", "msm", "poseidon", "quotient")


def mpt_workload(rng, trie, mpt, n_prefill: int, n_updates: int) -> list:
    """Pre-fill ``trie`` with n_prefill entries, then apply n_updates
    chained updates, inserts of new keys and updates of pre-filled keys in
    turn. Keys (k0, k1) are random field elements, values (lo, hi) random
    128-bit integers."""
    from zkevm_tpu_torch.ff.goldens import FR_MOD

    def key():
        return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(2)]

    def value():
        return [int.from_bytes(rng.bytes(16), "little") for _ in range(2)]

    prefilled = [key() for _ in range(n_prefill)]
    for k in prefilled:
        trie.update(k, value())
    ups = []
    for i in range(n_updates):
        k = key() if i % 2 == 0 else prefilled[i // 2]
        ups.append(mpt.apply_update(trie, k[0], k[1], *value()))
    for a, b in zip(ups, ups[1:]):
        if a.root_new != b.root_old:
            raise AssertionError("updates are not chained")
    return ups


def mock_row_counts(cs, asg) -> list[int]:
    """Rows the MockProver evaluates for each gate polynomial (padded to a
    power of two where selectors restrict it, all n otherwise)."""
    from zkevm_tpu_torch.plonk.mock import _peel_selectors

    counts = []
    for gate in cs.gates:
        for poly in gate.polys:
            sels, _ = _peel_selectors(poly)
            if not sels:
                counts.append(asg.n)
                continue
            mask = np.ones(asg.n, bool)
            for sq in sels:
                mask &= np.roll(np.any(asg.cols[sq.column] != 0, axis=1), -sq.rotation)
            rows = int(mask.sum())
            counts.append(1 << max(rows - 1, 0).bit_length() if rows else 0)
    return counts


def phase_mpt_main(torch, dev, seed: int) -> tuple[dict, list, int, int, dict]:
    import copy

    from zkevm_tpu_torch import kernels
    from zkevm_tpu_torch.circuits import mpt_circuit as mpt, mpt_small as ms, poseidon_table as pt
    from zkevm_tpu_torch.kzg import ParamsKZG
    from zkevm_tpu_torch.plonk import (Assignment, ConstraintSystem, MockProver, create_proof, keygen,
                                       verify_proof)
    from zkevm_tpu_torch.plonk import prover as prv
    from zkevm_tpu_torch.plonk.prover import proof_to_json
    from zkevm_tpu_torch.prover import vk_fingerprint
    from zkevm_tpu_torch.state import ZkTrie
    from zkevm_tpu_torch.transcript import PoseidonTranscript

    times = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        log(f"  {name}: {times[name]:.1f} s")
        return out

    rng = np.random.default_rng(seed)
    k, depth = MAIN_K, MPT_DEPTH
    n = 1 << k
    cs, ptcfg, mcfg = ms.build(ConstraintSystem, pt, mpt, depth=depth)
    slots = pt.capacity(cs, n)
    log(f"  MPT over PoseidonTable k={k}, depth {depth}: {len(cs.advice_columns)} advice, "
        f"{len(cs.fixed_columns)} fixed columns, {len(cs.gates)} gates, {len(cs.lookups)} lookups, "
        f"degree {cs.gate_degree()}; {MPT_PREFILL} entries, {MPT_UPDATES} chained updates; "
        f"{slots} table slots, {mpt.capacity(cs, n, depth)} update regions")

    # the lookup argument's host sort, timed per lookup
    lookup_s = []
    permute_lookup = prv._permute_lookup

    def timed_permute_lookup(*args):
        t = time.perf_counter()
        out = permute_lookup(*args)
        lookup_s.append(time.perf_counter() - t)
        return out

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with CompositeMeter(torch) as meter:
        ups = step("trie", lambda: mpt_workload(rng, ZkTrie(depth=depth), mpt, MPT_PREFILL, MPT_UPDATES))
        states = step("poseidon_states", lambda: mpt.poseidon_states(ups, depth, device=dev))
        if len(states) > slots:
            raise AssertionError(f"{len(states)} permutations > {slots} table slots")
        asg = Assignment(cs, n)
        step("table", lambda: pt.assign(cs, ptcfg, n, states, asg, device=dev))
        step("mpt_assign", lambda: mpt.assign(cs, mcfg, n, ups, asg, device=dev))
        failures = step("mock_prover", lambda: MockProver(cs, asg, device=dev).verify())
        params = step("unsafe_setup", lambda: ParamsKZG.unsafe_setup(k, tau=SETUP_TAU, device=dev))
        pk = step("keygen", lambda: keygen(params, cs, asg))
        prv._permute_lookup = timed_permute_lookup
        try:
            proof = step("create_proof", lambda: create_proof(params, pk, [], asg, seed=seed,
                                                              transcript=PoseidonTranscript()))
        finally:
            prv._permute_lookup = permute_lookup
        ok = step("verify_proof", lambda: verify_proof(params, pk.vk, [], proof,
                                                       transcript=PoseidonTranscript()))
    launches = kernels.launch_counts()
    log(f"  launches: {json.dumps(launches)}")
    log(f"  composites: {json.dumps(meter.summary())}")
    meter.check_quotient(pk.vk.domain.extended_n // pk.vk.domain.n)
    log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"  {len(states)} permutations in {slots} slots; lookup permutation host seconds: "
        + json.dumps([round(v, 2) for v in lookup_s]))
    if failures:
        raise AssertionError(f"MockProver failures on the honest witness: {failures[:8]}")
    if not ok:
        raise AssertionError("verify_proof rejected the MPT proof")
    bad = copy.deepcopy(proof)
    bad.evals[0] = (bad.evals[0] + 1) % 21888242871839275222246405745257275088548364400416034343698204186575808495617
    if verify_proof(params, pk.vk, [], bad, transcript=PoseidonTranscript()):
        raise AssertionError("verify_proof accepted an MPT proof with a tampered eval")
    forged = copy_assignment(asg)
    row = depth - 1  # root row of the first update
    forged.set_int(mcfg.root_new, row, forged.get_int(mcfg.root_new, row) ^ 1)
    forged_failures = MockProver(cs, forged, device=dev).verify()
    if not forged_failures:
        raise AssertionError("MockProver accepted a forged root")
    log(f"  MockProver: [] on the witness, {forged_failures} on a forged root; proof verified, "
        "tampered eval rejected")
    missing = [name for name in MPT_PATH_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the MPT path: {missing}")
    part = check_quotient_part(torch, rng, capture_part(
        lambda: create_proof(params, pk, [], asg, seed=seed, transcript=PoseidonTranscript())))
    reuse = {"cs": cs, "asg": asg, "vk_fingerprint": vk_fingerprint(pk.vk), "proof": proof_to_json(proof)}
    return ({"times": times, "launches": launches, "composites": meter.summary(), "quotient_part": part},
            states, slots, max(mock_row_counts(cs, asg)), reuse)


def phase_mpt_shapes(torch, rep: Report, gen, dev, states: list, slots: int, mock_rows: int,
                     plain_slots: int = 1 << 10) -> None:
    """Kernel E's trace of every table slot and kernel F over the
    MockProver's largest row set, each held to its plain version."""
    from zkevm_tpu_torch.ff import field as ff
    from zkevm_tpu_torch.hash import poseidon as pos

    spec = pos.P128_POW5_T3
    init = torch.zeros(slots, 3, 8, dtype=torch.int32, device=dev)
    init[: len(states)] = _encode_states(torch, states, dev)
    got = pos.permute_trace(spec, init)
    want, pms = plain_ms_of(torch, lambda: pos.PLAIN["trace"](spec, init[:plain_slots]))
    check_equal(f"poseidon trace, slots 0..{plain_slots}", max_abs_err(torch, got[:, :plain_slots], want))
    del got, want
    ms = cuda_ms(torch, lambda: pos.permute_trace(spec, init), reps=3)
    rounds = spec.r_f + spec.r_p
    rep.rows["poseidon"].update(main_shape_entry(
        "poseidon", f"trace of {slots} slots", ms, pms / 1e3, f"the first {plain_slots} slots",
        96 * slots + 96 * (rounds + 1) * slots, POSEIDON_INT_OPS * slots))
    x = random_words_with_zeros(torch, (mock_rows,), gen, dev)
    got = ff.nonzero(x)
    want, pms = plain_ms_of(torch, lambda: ff.PLAIN["nonzero"](x))
    check_equal(f"nonzero ({mock_rows}, 8)", max_abs_err(torch, got, want))
    ms = cuda_ms(torch, lambda: ff.nonzero(x))
    lib = cuda_ms(torch, lambda: (x != 0).any(-1))
    rep.rows["field_nonzero"].update(main_shape_entry(
        "field_nonzero", f"({mock_rows}, 8) words", ms, pms / 1e3, "whole", 33 * mock_rows, 0,
        library_ms=lib))


# ---------------------------------------------------------------------------
# phase 8: the SRS-file path at size k, on phase 6's circuit and assignment
# ---------------------------------------------------------------------------

SRS_PATH_KERNELS = ("field_mul", "field_add_sub", "field_pow", "ntt", "g1_scalar_mul", "pippenger",
                    "kzg_open", "quotient")
SRS_SPOT = (0, 1, 2, 12345, (1 << MAIN_K) - 1)  # points of each section held to the goldens


def _file_point(data: bytes, offset: int):
    from zkevm_tpu_torch.kzg import srs

    return (srs._fq_unraw(data[offset : offset + 32]), srs._fq_unraw(data[offset + 32 : offset + 64]))


def check_srs_file(path, k: int, tau: int) -> None:
    """The file's size, and the points SRS_SPOT of both sections against
    [tau^i] G1 and [L_i(tau)] G1 from the host goldens."""
    from zkevm_tpu_torch.ec import goldens as g1g
    from zkevm_tpu_torch.ff.goldens import FR_MOD, fr_root_of_unity

    n = 1 << k
    data = Path(path).read_bytes()
    if len(data) != 4 + 2 * n * 64 + 256 or int.from_bytes(data[:4], "little") != k:
        raise AssertionError(f"params file: {len(data)} bytes, k={int.from_bytes(data[:4], 'little')}")
    omega = fr_root_of_unity(k)
    zn = (pow(tau, n, FR_MOD) - 1) * pow(n, FR_MOD - 2, FR_MOD) % FR_MOD
    for i in SRS_SPOT:
        wi = pow(omega, i, FR_MOD)
        lag = zn * wi * pow((tau - wi) % FR_MOD, FR_MOD - 2, FR_MOD) % FR_MOD
        if _file_point(data, 4 + 64 * i) != g1g.scalar_mul(g1g.G1_GEN, pow(tau, i, FR_MOD)):
            raise AssertionError(f"params file: g1[{i}] != [tau^{i}] G1")
        if _file_point(data, 4 + 64 * (n + i)) != g1g.scalar_mul(g1g.G1_GEN, lag):
            raise AssertionError(f"params file: lagrange[{i}] != [L_{i}(tau)] G1")
    log(f"  {len(data)} bytes; points {list(SRS_SPOT)} of both sections equal the goldens")


def phase_srs_file(torch, rep: Report, rng, dev, seed: int, mpt: dict) -> dict:
    import copy

    from zkevm_tpu_torch import kernels
    from zkevm_tpu_torch.ec import group, msm as msmmod, pippenger as pip
    from zkevm_tpu_torch.ff import field as ff
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.kzg import ParamsKZG, open_single, verify_single
    from zkevm_tpu_torch.kzg.srs import load_params_file, params_path, write_params_file
    from zkevm_tpu_torch.plonk import create_proof, keygen, verify_proof
    from zkevm_tpu_torch.plonk.prover import proof_to_json
    from zkevm_tpu_torch.prover import vk_fingerprint
    from zkevm_tpu_torch.transcript import PoseidonTranscript

    times = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        log(f"  {name}: {times[name]:.1f} s")
        return out

    k = MAIN_K
    n = 1 << k
    cs, asg = mpt["cs"], mpt["asg"]
    srs_dir = ROOT / "build" / "srs"
    srs_dir.mkdir(parents=True, exist_ok=True)
    path = params_path(str(srs_dir), k)
    # the fullest advice column, in evaluation form, for the opening
    fullest = max(cs.advice_columns, key=lambda c: int(np.any(asg.cols[c] != 0, axis=1).sum()))
    column = ff.to_tensor(asg.cols[fullest], dev)
    z = int.from_bytes(rng.bytes(32), "little") % FR.modulus

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    setup = step("unsafe_setup", lambda: ParamsKZG.unsafe_setup(k, tau=SETUP_TAU, device=dev))
    step("write_params_file", lambda: write_params_file(setup, path, tau=SETUP_TAU))
    del setup
    params = step("load_params_file", lambda: load_params_file(path, k, device=dev))
    with CompositeMeter(torch) as meter:
        pk = step("keygen", lambda: keygen(params, cs, asg))
        proof = step("create_proof", lambda: create_proof(params, pk, [], asg, seed=seed,
                                                          transcript=PoseidonTranscript()))
        ok = step("verify_proof", lambda: verify_proof(params, pk.vk, [], proof,
                                                       transcript=PoseidonTranscript()))
    commitment = step("commit_lagrange", lambda: params.commit_lagrange(column))
    value, opening = step("open_single", lambda: open_single(params, column, z))
    opened = step("verify_single", lambda: verify_single(params, commitment, z, value, opening))
    launches = kernels.launch_counts()
    log(f"  launches: {json.dumps(launches)}")
    log(f"  composites: {json.dumps(meter.summary())}")
    meter.check_quotient(pk.vk.domain.extended_n // pk.vk.domain.n)
    log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    check_srs_file(path, k, SETUP_TAU)
    if not isinstance(params.committer, pip.PippengerMSM):
        raise AssertionError(f"load_params_file at k={k}: engine {type(params.committer).__name__}")
    if vk_fingerprint(pk.vk) != mpt["vk_fingerprint"]:
        raise AssertionError("the file-loaded SRS gives another vk fingerprint than unsafe_setup's")
    got = proof_to_json(proof)
    bad_fields = [f for f in got if got[f] != mpt["proof"][f]]
    if bad_fields:
        raise AssertionError(f"proof fields differ from phase 6's proof: {bad_fields}")
    if not ok:
        raise AssertionError("verify_proof rejected the proof made with the file-loaded SRS")
    bad = copy.deepcopy(proof)
    bad.evals[0] = (bad.evals[0] + 1) % FR.modulus
    if verify_proof(params, pk.vk, [], bad, transcript=PoseidonTranscript()):
        raise AssertionError("verify_proof accepted a tampered eval (file-loaded SRS)")
    if not opened or verify_single(params, commitment, z, (value + 1) % FR.modulus, opening):
        raise AssertionError("verify_single: the opening is rejected, or value + 1 accepted")
    log(f"  engine PippengerMSM; vk fingerprint and all {len(got)} proof fields equal phase 6's; "
        "proof verified, tampered eval rejected; open_single verified, value + 1 rejected")
    missing = [name for name in SRS_PATH_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the SRS-file path: {missing}")
    if launches["msm"]:
        raise AssertionError(f"C's msm launched {launches['msm']} times on the SRS-file path")

    # kernel G at the path's own shape (Lw = 1024 lanes of 1024 steps over
    # the loaded bases): against its plain version word for word, and
    # against C's MSM over the same bases by affine points
    sc = ff.to_tensor(ff.words_from_ints([int.from_bytes(rng.bytes(32), "little") % FR.modulus
                                          for _ in range(n)]), dev)
    got_g = params.committer(sc)
    want, pms = plain_ms_of(torch, lambda: pip.PLAIN["msm"](params.g1_powers, sc, c=params.committer.c,
                                                             sublanes=params.committer.sublanes))
    check_equal(f"pippenger msm at n={n} (the loaded SRS)", max_abs_err(torch, got_g, want))
    c_msm = msmmod.MSM(params.g1_powers)
    bits = ff.to_tensor(ff.words_from_ints(list(rng.integers(0, 2, n))), dev)
    for label, s_ in (("random", sc), ("all-zero", torch.zeros_like(sc)), ("0/1", bits)):
        own = got_g if s_ is sc else params.committer(s_)
        if group.to_affine_ints(own) != group.to_affine_ints(c_msm(s_)):
            raise AssertionError(f"pippenger msm differs from C's msm at n={n} ({label} scalars)")
    del c_msm
    ms = cuda_ms(torch, lambda: params.committer(sc), reps=3)
    stages = stage_ms(torch, lambda marks: pip.msm_affine(params.committer.affine, sc, c=params.committer.c,
                                                          sublanes=params.committer.sublanes, marks=marks))
    entry = main_shape_entry("pippenger", f"n={n}, c=4 unsigned, the loaded SRS", ms, pms / 1e3, "whole",
                             128 * n + 96, pippenger_int_ops(torch, sc, params.committer.c, False,
                                                             params.committer.sublanes))
    log("  pippenger at the loaded SRS equals its plain version word for word and C's msm (affine) on random, "
        "all-zero and 0/1 scalars; stages " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    entry["main_shape_held_to"] = ("its plain version, word for word; C's msm, affine (random, all-zero and "
                                   "0/1 scalars)")
    entry["main_shape_stages_ms"] = stages
    entry["main_shape_yardstick_ms"] = yardstick(torch, sc)
    rep.rows["pippenger"].update(entry)
    return {"times": times, "launches": launches, "composites": meter.summary()}


# ---------------------------------------------------------------------------
# phase 9: the mesh path (parallel/mesh.py over NCCL, a world of one GPU) at
# size k, on phase 6's circuit, assignment and seed
# ---------------------------------------------------------------------------

MESH_PROOF_KERNELS = ("field_mul", "field_add_sub", "field_pow", "ntt", "pippenger", "quotient")
MESH_SUBLANES = 128  # sharded_msm_t's Lw
MESH_SMALL = 1 << 12  # the mesh MSM held to its plain version at this many points
MESH_PLAIN16 = 1 << 14  # ... and at c = 16 at this many


def phase_mesh(torch, rep: Report, gen, rng, dev, seed: int, mpt: dict) -> dict:
    import copy
    import datetime
    import os

    import torch.distributed as dist

    from zkevm_tpu_torch import kernels
    from zkevm_tpu_torch.ec import group, msm as msmmod, pippenger as pip
    from zkevm_tpu_torch.ff import field as ff
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.kzg import ParamsKZG
    from zkevm_tpu_torch.parallel import mesh as pm
    from zkevm_tpu_torch.plonk import create_proof, keygen, verify_proof
    from zkevm_tpu_torch.plonk.prover import proof_to_json
    from zkevm_tpu_torch.poly import ntt as nt
    from zkevm_tpu_torch.prover import vk_fingerprint
    from zkevm_tpu_torch.transcript import PoseidonTranscript

    times = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        log(f"  {name}: {times[name]:.1f} s")
        return out

    k = MAIN_K
    n = 1 << k
    store = ROOT / "build" / f"mesh_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: NCCL's bootstrap on the loopback
    torch.cuda.set_device(torch.cuda.current_device())
    step("init_process_group", lambda: dist.init_process_group(
        "nccl", init_method=f"file://{store}", rank=0, world_size=1, timeout=datetime.timedelta(minutes=5)))
    try:
        mesh = pm.default_mesh()
        log(f"  mesh: world {mesh.world}, rank {mesh.rank}, {mesh.device}, backend {dist.get_backend()}")
        params = step("unsafe_setup", lambda: ParamsKZG.unsafe_setup(k, tau=SETUP_TAU, device=dev))
        pts = params.g1_powers
        sc = ff.to_tensor(ff.words_from_ints([int.from_bytes(rng.bytes(32), "little") % FR.modulus
                                              for _ in range(n)]), dev)
        polys = random_field(torch, FR, 16 * n, gen, dev).reshape(16, n, 8)
        cols = {kk: random_field(torch, FR, 1 << kk, gen, dev) for kk in (k, 22)}

        # the mesh functions, counted: the point-sharded MSMs at 2^20, the
        # batch-sharded NTT (16 columns) and the four-step NTT (k = 20, 22)
        calls = [("sharded_msm", lambda: pm.sharded_msm(mesh, pts, sc)),
                 ("sharded_msm_t_scan", lambda: pm.sharded_msm_t_scan(mesh, pts, sc)),
                 ("sharded_msm_t c=4", lambda: pm.sharded_msm_t(mesh, pts, sc, c=4)),
                 ("sharded_msm_t c=16", lambda: pm.sharded_msm_t(mesh, pts, sc, c=16)),
                 ("sharded_ntt_batch", lambda: pm.sharded_ntt_batch(mesh, polys, k))]
        calls += [(f"sharded_ntt_t k={kk} inverse={inv}",
                   lambda kk=kk, inv=inv: pm.sharded_ntt_t(mesh, cols[kk], kk, inverse=inv))
                  for kk in cols for inv in (False, True)]
        kernels.reset_launches()
        pm.reset_collectives()
        got = {name: step(name, fn) for name, fn in calls}
        api_launches = kernels.launch_counts()
        api_collectives = pm.collective_counts()
        log(f"  launches: {json.dumps(api_launches)}")
        log(f"  collectives: {json.dumps(api_collectives)}")

        # ... against C's MSM (affine), G's msm with the same parameters, B
        # and I (words)
        want = group.to_affine_ints(msmmod.MSM(pts)(sc))
        for name in ("sharded_msm", "sharded_msm_t_scan", "sharded_msm_t c=4", "sharded_msm_t c=16"):
            if group.to_affine_ints(got[name]) != want:
                raise AssertionError(f"{name} differs from C's msm at n={n}")
        for c in (4, 16):
            check_equal(f"sharded_msm_t c={c} against G's msm",
                        max_abs_err(torch, got[f"sharded_msm_t c={c}"],
                                    pip.msm(pts, sc, c=c, sublanes=MESH_SUBLANES)))
        if not torch.equal(got["sharded_ntt_batch"], nt.ntt(polys, k)):
            raise AssertionError(f"sharded_ntt_batch differs from kernel B at k={k}, 16 columns")
        for kk, a in cols.items():
            for inv in (False, True):
                if not torch.equal(got[f"sharded_ntt_t k={kk} inverse={inv}"], nt.ntt_t(a, kk, inverse=inv)):
                    raise AssertionError(f"sharded_ntt_t k={kk} inverse={inv} differs from kernel I's ntt_t")
        check_equal(f"sharded_ntt_t k={k} against its plain version",
                    max_abs_err(torch, got[f"sharded_ntt_t k={k} inverse=False"],
                                pm.PLAIN["sharded_ntt_t"](mesh, cols[k], k)))
        del got, polys
        missing = [name for name in ("ntt", "ntt4", "g1_add", "g1_scalar_mul", "pippenger")
                   if api_launches[name] == 0]
        if missing or not all(api_collectives.values()):
            raise AssertionError(f"mesh functions: kernels never launched {missing}, "
                                 f"collectives {api_collectives}")
        mesh_ms = {c: cuda_ms(torch, lambda c=c: pm.sharded_msm_t(mesh, pts, sc, c=c), reps=1) for c in (4, 16)}
        # the engine of the mesh proof (its shard's affine bases made once),
        # G alone over the same affine bases by stage, and on all-zero and 0/1
        # scalars against C
        engine = pm.MeshMSM(mesh, pts)
        engine_ms = cuda_ms(torch, lambda: engine(sc), reps=3)
        g16_ms = cuda_ms(torch, lambda: pip.msm_affine(engine._affine, sc, c=16, sublanes=MESH_SUBLANES), reps=3)
        g16_stages = stage_ms(torch, lambda marks: pip.msm_affine(engine._affine, sc, c=16, sublanes=MESH_SUBLANES,
                                                                  marks=marks))
        c_msm = msmmod.MSM(pts)
        bits = ff.to_tensor(ff.words_from_ints(list(rng.integers(0, 2, n))), dev)
        for label, s_ in (("all-zero", torch.zeros_like(sc)), ("0/1", bits)):
            if group.to_affine_ints(engine(s_)) != group.to_affine_ints(c_msm(s_)):
                raise AssertionError(f"MeshMSM differs from C's msm at n={n} ({label} scalars)")
        del c_msm, bits
        ntt_ms = {kk: cuda_ms(torch, lambda kk=kk: pm.sharded_ntt_t(mesh, cols[kk], kk)) for kk in cols}
        part = pip.msm(pts[:MESH_SMALL], sc[:MESH_SMALL], c=4, sublanes=MESH_SUBLANES)
        gather_ms = cuda_ms(torch, lambda: pm._gather_fold(mesh, part, group.add), reps=20)
        log(f"  sharded_msm, sharded_msm_t_scan, sharded_msm_t (c=4, 16) equal C's msm at n={n} (affine), "
            f"sharded_msm_t equals G's msm word for word; sharded_ntt_batch equals B (16 columns, k={k}); "
            f"sharded_ntt_t and its inverse equal I's ntt_t at k={k} and 22 (and its plain version at "
            f"k={k}); sharded_msm_t c=16 {mesh_ms[16]:.2f} ms (G's msm alone {g16_ms:.2f} ms), c=4 "
            f"{mesh_ms[4]:.2f} ms; MeshMSM {engine_ms:.2f} ms (equal to C's msm on all-zero and 0/1 scalars), "
            f"G's stages " + json.dumps({key: round(v, 4) for key, v in g16_stages.items()}) + "; "
            f"sharded_ntt_t {ntt_ms[k]:.4f} ms at k={k}, {ntt_ms[22]:.4f} ms at k=22; "
            f"all_gather + fold {gather_ms:.4f} ms")
        del engine
        del cols, part
        # the mesh MSM at MESH_SMALL points against its plain version
        # (G's and C's plain versions around the same NCCL gather)
        small = (pts[:MESH_SMALL], sc[:MESH_SMALL])
        small_got = pm.sharded_msm_t(mesh, *small, c=4)
        plain, pms = plain_ms_of(torch, lambda: pm.PLAIN["sharded_msm_t"](mesh, *small, c=4))
        check_equal(f"sharded_msm_t at n={MESH_SMALL}", max_abs_err(torch, small_got, plain))
        small_ms = cuda_ms(torch, lambda: pm.sharded_msm_t(mesh, *small, c=4))
        rep.record("mesh", f"sharded_msm_t n={MESH_SMALL}, c=4, world 1", 0, small_ms, pms,
                   128 * MESH_SMALL + 96 * 2,
                   pippenger_int_ops(torch, small[1], 4, False, MESH_SUBLANES))
        del small_got, plain, small
        # G at the mesh engine's c = 16 (C's sorted accumulation and the fold
        # in 14 levels) against its plain version, on MESH_PLAIN16 points:
        # the plain fold walks every bucket whatever n is
        small = (pts[:MESH_PLAIN16], sc[:MESH_PLAIN16])
        if len(msmmod.fold_levels(pip.num_buckets(16, False))) != 14:
            raise AssertionError("c=16 does not fold in 14 levels")
        small_got = pm.sharded_msm_t(mesh, *small, c=16)
        plain, plain16_ms = plain_ms_of(torch, lambda: pm.PLAIN["sharded_msm_t"](mesh, *small, c=16))
        plain16_err = max_abs_err(torch, small_got, plain)
        check_equal(f"sharded_msm_t c=16 at n={MESH_PLAIN16} against its plain version", plain16_err)
        small16_ms = cuda_ms(torch, lambda: pm.sharded_msm_t(mesh, *small, c=16), reps=3)
        log(f"  sharded_msm_t c=16, Lw={MESH_SUBLANES} at n={MESH_PLAIN16} equals its plain version word for "
            f"word: {small16_ms:.2f} ms, plain {plain16_ms / 1e3:.1f} s")
        del small_got, plain, small
        torch.cuda.empty_cache()

        # the main path: the MPT proof with every commitment through MeshMSM
        cs, asg = mpt["cs"], mpt["asg"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        pm.reset_collectives()
        with CompositeMeter(torch) as meter:
            step("use_mesh", lambda: params.use_mesh())
            pk = step("keygen", lambda: keygen(params, cs, asg))
            proof = step("create_proof", lambda: create_proof(params, pk, [], asg, seed=seed,
                                                              transcript=PoseidonTranscript()))
            ok = step("verify_proof", lambda: verify_proof(params, pk.vk, [], proof,
                                                           transcript=PoseidonTranscript()))
        launches = kernels.launch_counts()
        collectives = pm.collective_counts()
        log(f"  launches: {json.dumps(launches)}")
        log(f"  collectives: {json.dumps(collectives)}")
        log(f"  composites: {json.dumps(meter.summary())}")
        meter.check_quotient(pk.vk.domain.extended_n // pk.vk.domain.n)
        log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        if not isinstance(params.committer, pm.MeshMSM) or params.committer.scan or params.committer.c != 16:
            raise AssertionError(f"use_mesh: engine {params.committer!r}")
        if vk_fingerprint(pk.vk) != mpt["vk_fingerprint"]:
            raise AssertionError("the mesh-committed keygen gives another vk fingerprint than phase 6's")
        got = proof_to_json(proof)
        bad_fields = [f for f in got if got[f] != mpt["proof"][f]]
        if bad_fields:
            raise AssertionError(f"mesh proof fields differ from phase 6's proof: {bad_fields}")
        if not ok:
            raise AssertionError("verify_proof rejected the mesh-committed proof")
        bad = copy.deepcopy(proof)
        bad.evals[0] = (bad.evals[0] + 1) % FR.modulus
        if verify_proof(params, pk.vk, [], bad, transcript=PoseidonTranscript()):
            raise AssertionError("verify_proof accepted a tampered eval (mesh)")
        missing = [name for name in MESH_PROOF_KERNELS if launches[name] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the mesh proof: {missing}")
        if launches["msm"] or not sum(collectives.values()):
            raise AssertionError(f"mesh path: C's msm launched {launches['msm']} times, "
                                 f"collectives {collectives}")
        log(f"  engine MeshMSM (c=16, world 1); vk fingerprint and all {len(got)} proof fields equal "
            "phase 6's; proof verified, tampered eval rejected")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    entry = {
        "main_shape": f"MeshMSM n={n}, c=16, Lw={MESH_SUBLANES}, world 1 (the mesh proof's commit)",
        "main_shape_ms": engine_ms, "main_shape_sharded_msm_t_ms": mesh_ms[16], "main_shape_c4_ms": mesh_ms[4],
        "main_shape_unsharded_ms": g16_ms, "main_shape_stages_ms": g16_stages,
        "main_shape_yardstick_ms": yardstick(torch, sc),
        "main_shape_held_to": "G's msm with the same parameters, word for word; C's msm, affine; "
                              f"its plain version on the first {MESH_PLAIN16} points, word for word",
        "main_shape_max_abs_err": plain16_err,
        "main_shape_plain_ms": plain16_ms,
        "main_shape_plain_on": f"the first {MESH_PLAIN16} points, same c=16 and Lw={MESH_SUBLANES} "
                               "(every bucket of every window in the fold)",
        "main_shape_ms_at_plain_n": small16_ms,
        "all_gather_fold_ms": gather_ms, "sharded_ntt_t_ms": ntt_ms,
        "collectives": {"mesh_functions": api_collectives, "mesh_proof": collectives},
        "local_launches": {window: {name: counts[name] for name in ("ntt", "ntt4", "g1_add", "g1_scalar_mul",
                                                                     "pippenger")}
                           for window, counts in (("mesh_functions", api_launches), ("mesh_proof", launches))},
    }
    entry["main_shape_bound_ms"], entry["main_shape_bound_by"] = bound(
        128 * n + 96 * 2, pippenger_int_ops(torch, sc, 16, False, MESH_SUBLANES))
    rep.rows["mesh"].update(entry)
    return {"times": times, "functions": {"launches": api_launches, "collectives": api_collectives},
            "proof": {"launches": launches, "collectives": collectives}, "composites": meter.summary()}


# ---------------------------------------------------------------------------
# phase 10: the l13 path (the reference's default engine on its accelerator,
# ec/msm13.py) at size k, on phase 6's circuit, assignment and seed
# ---------------------------------------------------------------------------

L13_PATH_KERNELS = ("field_mul", "field_add_sub", "field_pow", "ntt", "g1_scalar_mul", "lazy13", "msm13",
                    "quotient")


def phase_l13(torch, rep: Report, rng, dev, seed: int, mpt: dict) -> dict:
    import copy

    from zkevm_tpu_torch import kernels
    from zkevm_tpu_torch.ec import group, msm as msmmod, msm13 as m13
    from zkevm_tpu_torch.ff import field as ff, lazy13 as lz
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.kzg import ParamsKZG
    from zkevm_tpu_torch.plonk import create_proof, keygen, verify_proof
    from zkevm_tpu_torch.plonk.prover import proof_to_json
    from zkevm_tpu_torch.prover import vk_fingerprint
    from zkevm_tpu_torch.transcript import PoseidonTranscript

    times = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        log(f"  {name}: {times[name]:.1f} s")
        return out

    k = MAIN_K
    n = 1 << k
    cs, asg = mpt["cs"], mpt["asg"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    calls = []
    call = m13.Msm13.__call__

    def counted(engine, scalars):
        calls.append(scalars.shape[0])
        return call(engine, scalars)

    m13.Msm13.__call__ = counted
    try:
        with CompositeMeter(torch) as meter:
            params = step("unsafe_setup", lambda: ParamsKZG.unsafe_setup(k, tau=SETUP_TAU, device=dev, engine="l13"))
            pk = step("keygen", lambda: keygen(params, cs, asg))
            proof = step("create_proof", lambda: create_proof(params, pk, [], asg, seed=seed,
                                                              transcript=PoseidonTranscript()))
            ok = step("verify_proof", lambda: verify_proof(params, pk.vk, [], proof, transcript=PoseidonTranscript()))
    finally:
        m13.Msm13.__call__ = call
    launches = kernels.launch_counts()
    engine = params.committer
    proof_fallbacks = engine.fallbacks
    log(f"  launches: {json.dumps(launches)}")
    log(f"  composites: {json.dumps(meter.summary())}")
    meter.check_quotient(pk.vk.domain.extended_n // pk.vk.domain.n)
    log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"  Msm13 calls {len(calls)} (of {sorted(set(calls))} points), fallbacks {engine.fallbacks}")
    if not isinstance(engine, m13.Msm13) or (engine.c, engine.lanes, engine.wgroup) != (16, 4096, 8):
        raise AssertionError(f"unsafe_setup(engine='l13'): engine {engine!r}")
    if vk_fingerprint(pk.vk) != mpt["vk_fingerprint"]:
        raise AssertionError("the l13-committed keygen gives another vk fingerprint than phase 6's")
    got = proof_to_json(proof)
    bad_fields = [f for f in got if got[f] != mpt["proof"][f]]
    if bad_fields:
        raise AssertionError(f"l13 proof fields differ from phase 6's proof: {bad_fields}")
    if not ok:
        raise AssertionError("verify_proof rejected the l13-committed proof")
    bad = copy.deepcopy(proof)
    bad.evals[0] = (bad.evals[0] + 1) % FR.modulus
    if verify_proof(params, pk.vk, [], bad, transcript=PoseidonTranscript()):
        raise AssertionError("verify_proof accepted a tampered eval (l13)")
    missing = [name for name in L13_PATH_KERNELS if launches[name] == 0]
    if missing or launches["msm"] or not calls or proof_fallbacks:
        raise AssertionError(f"l13 path: kernels never launched {missing}, C's msm launched {launches['msm']} "
                             f"times, {len(calls)} Msm13 calls, {proof_fallbacks} fallbacks")
    log(f"  engine Msm13 (c=16, lanes 4096, wgroup 8): {launches['msm13']} launches of L, "
        f"{proof_fallbacks} fallbacks; vk fingerprint and all {len(got)} proof fields equal phase 6's; "
        "proof verified, tampered eval rejected")

    # kernel L at the path's shape: the reference bench's MSM (2^20 points,
    # c = 16, lanes 4096, window groups of 8) against its plain version word
    # for word on random scalars, and L's own result against C's MSM by
    # affine points on random and 0/1 scalars, with no flag
    sc = ff.to_tensor(ff.words_from_ints(_random_scalars(n, rng)), dev)
    bits = ff.to_tensor(ff.words_from_ints(list(rng.integers(0, 2, n))), dev)
    got_l, flag = engine.raw(sc)
    (want, wflag), pms = plain_ms_of(torch, lambda: m13.PLAIN["msm13"](engine.ax13, engine.ay13, sc, 16, 254, 4096, 8,
                                                                       lane_radix=m13.LANE_RADIX))
    err = max([max_abs_err(torch, getattr(got_l, c), getattr(want, c)) for c in ("x", "y", "z")]
              + [int((got_l.inf != want.inf).sum().item()), abs(flag - wflag)])
    check_equal(f"msm13 at n={n}, c=16", err)
    del want
    c_msm = msmmod.MSM(params.g1_powers)
    for label, s_ in (("random", sc), ("0/1", bits)):
        own, oflag = (got_l, flag) if s_ is sc else engine.raw(s_)
        if oflag or group.to_affine_ints(m13.to_point(own)) != group.to_affine_ints(c_msm(s_)[None]):
            raise AssertionError(f"msm13 at n={n}, c=16 ({label} scalars): flag {oflag}, or its own result "
                                 "differs from C's msm")
    ms16 = cuda_ms(torch, lambda: engine.raw(sc), reps=3)
    c_ms = cuda_ms(torch, lambda: c_msm(sc), reps=3)
    split = msm13_split(torch, engine, sc)
    log(f"  msm13 at n={n}, c=16 equals its plain version word for word (flag {flag}; plain {pms / 1e3:.1f} s) "
        f"and C's msm on random and 0/1 scalars: {ms16:.2f} ms (C's msm {c_ms:.2f} ms)")
    # kernel J at the path's shape: the SRS's affine coordinates into lazy-13
    # limbs (from_words over the 2^20 x of the engine), against its plain version
    ax_words = lz.to_words(engine.ax13)
    jerr = max_abs_err(torch, lz.from_words(ax_words), engine.ax13)
    (jwant, jpms) = plain_ms_of(torch, lambda: by_chunks(torch, lambda sl: lz.PLAIN["from_words"](ax_words[sl]), n)[0])
    jerr = max(jerr, max_abs_err(torch, lz.from_words(ax_words), jwant))
    check_equal(f"lazy13 from_words at n={n}", jerr)
    rep.rows["lazy13"].update(main_shape_entry(
        "lazy13", f"from_words ({n}, 8) -> (21, {n}) Fq", cuda_ms(torch, lambda: lz.from_words(ax_words)),
        jpms / 1e3, "whole, 2^16 at a time", (32 + 84) * n, 0))
    b, by = bound(*msm13_work(torch, sc, 16))
    rep.rows["msm13"].update({
        "main_shape": f"msm13 n={n}, c=16, lanes=4096, wgroup=8 (the l13 engine's, the reference bench's)",
        "main_shape_ms": ms16, "main_shape_max_abs_err": err, "main_shape_plain_ms": pms,
        "main_shape_plain_on": "whole", "main_shape_bound_ms": b, "main_shape_bound_by": by,
        "main_shape_held_to": "its plain version with L's lane offsets (lane_radix), word for word and flag "
                              "(random scalars), and C's msm by affine point (random and 0/1 scalars), flag 0",
        "main_shape_flag": flag, "c_msm_ms": c_ms,
        "proof_calls": len(calls), "proof_fallbacks": proof_fallbacks,
        **{f"main_shape_{k}": v for k, v in split.items()},
    })
    return {"times": times, "launches": launches, "composites": meter.summary(), "calls": len(calls)}


# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from zkevm_tpu_torch import kernels

    t0 = time.perf_counter()
    log(card_line())
    dev = torch.device("cuda")

    t = time.perf_counter()
    built = kernels.build_all()
    log(f"phase build: {time.perf_counter() - t:.1f} s " + json.dumps({k: round(v, 1) for k, v in built.items()}))
    ptxas = {lib: ptxas_summary(kernels.BUILD_LOGS.get(lib, ""))
             for lib in ("curve", "pippenger", "quotient", "ntt", "msm13")}
    log("  ptxas -v of C, G, M, B and L: " + json.dumps(ptxas))

    rep = Report()
    gen = torch.Generator().manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    t = time.perf_counter()
    phase_field(torch, rep, gen, dev, 1 << 20)
    phase_ntt(torch, rep, gen, dev)
    phase_ntt4(torch, rep, gen, dev)
    phase_ntt4_shapes(torch, rep, gen, dev)
    phase_ntt4_layout(torch, gen, dev)
    phase_curve(torch, rep, rng, dev)
    phase_keccak(torch, rep, gen, dev)
    phase_poseidon(torch, rep, gen, dev)
    phase_nonzero(torch, rep, gen, dev)
    phase_pippenger(torch, rep, rng, dev)
    phase_kzg_open(torch, rep, gen, rng, dev)
    phase_lazy13(torch, rep, gen, dev)
    phase_msm13(torch, rep, rng, dev)
    phase_quotient(torch, rep, gen, dev)
    log(f"phase kernels: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    phase_toy(torch, dev)
    log(f"phase toy: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_mpt_small(torch, dev)
    log(f"phase mpt small: {time.perf_counter() - t:.1f} s")

    paths = {}
    t = time.perf_counter()
    keccak_path, params, domain = phase_main(torch, dev, args.seed)
    paths["keccak_table"] = keccak_path["launches"]
    quotient_parts = {"keccak_table": keccak_path["quotient_part"]}
    log(f"phase main: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    phase_main_shapes(torch, rep, gen, rng, dev, params, domain)
    log(f"phase main shapes: {time.perf_counter() - t:.1f} s")
    del params, domain
    torch.cuda.empty_cache()

    t = time.perf_counter()
    mpt_path, states, slots, mock_rows, mpt_reuse = phase_mpt_main(torch, dev, args.seed)
    paths["mpt"] = mpt_path["launches"]
    quotient_parts["mpt"] = mpt_path["quotient_part"]
    log(f"phase mpt main: {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    phase_mpt_shapes(torch, rep, gen, dev, states, slots, mock_rows)
    log(f"phase mpt main shapes: {time.perf_counter() - t:.1f} s")
    del states
    torch.cuda.empty_cache()

    t = time.perf_counter()
    srs_path = phase_srs_file(torch, rep, rng, dev, args.seed, mpt_reuse)
    paths["srs_file"] = srs_path["launches"]
    log(f"phase srs file: {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    mesh_path = phase_mesh(torch, rep, gen, rng, dev, args.seed, mpt_reuse)
    windows = {"mesh_functions": mesh_path["functions"], "mesh_proof": mesh_path["proof"]}
    for window, counts in windows.items():
        paths[window] = counts["launches"]
    log(f"phase mesh: {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    l13_path = phase_l13(torch, rep, rng, dev, args.seed, mpt_reuse)
    paths["l13"] = l13_path["launches"]
    log(f"phase l13: {time.perf_counter() - t:.1f} s")

    # kernel M on one whole quotient part of each main path
    kp = quotient_parts["keccak_table"]
    rep.rows["quotient"].update(
        main_shape=kp["shape"], main_shape_max_abs_err=0, main_shape_ms=kp["ms"],
        main_shape_plain_ms=kp["plain_ms"], main_shape_plain_on=kp["plain_on"],
        main_shape_bound_ms=kp["bound_ms"], main_shape_bound_by=kp["bound_by"],
        main_shape_library_ms=None, parts=quotient_parts)

    # launches: the sum over the main paths, each counted from zero over
    # its own run, with the count of each path beside it (the mesh path in
    # two windows: its functions called directly, then the use_mesh proof);
    # the mesh row's are its collectives (the mesh path alone issues any)
    for name, row in rep.rows.items():
        if name == "mesh":
            row["launches_by_path"] = {path: 0 for path in paths}
            for window, counts in windows.items():
                row["launches_by_path"][window] = sum(counts["collectives"].values())
        else:
            row["launches_by_path"] = {path: counts[name] for path, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())

    rep.rows["msm"]["ptxas"] = ptxas["curve"]
    rep.rows["pippenger"]["ptxas"] = ptxas["pippenger"]
    rep.rows["quotient"]["ptxas"] = ptxas["quotient"]
    rep.rows["ntt"]["ptxas"] = ptxas["ntt"]
    rep.rows["msm13"]["ptxas"] = ptxas["msm13"]
    log(f"total: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": list(rep.rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
