"""Multi-permutation keccak sponge circuit exposing the KeccakTable.

Port of ``zkevm_tpu/circuits/keccak_table.py`` (host code: configuration
and witness assignment; columns are (n, 8) Montgomery words).

Reference counterpart: zkevm-circuits/src/keccak_circuit.rs:48 +
keccak_packed_multi.rs (~1M rows of many hashes behind an RLC table) and
witness/keccak.rs:14 (multi_keccak). This is the TPU-native redesign of
that role on top of round 1's bit-level vector-column permutation
(circuits/keccak_circuit.py, which remains the standalone single-block
proof of BASELINE milestone #1 — instances can't carry challenge-dependent
RLCs, so the table variant is the composition surface):

- permutations are packed at stride PERM = 1825 rows with periodic
  selectors; sponge chaining is a constant row rotation (prev perm's
  round-23 output rows sit exactly 25 rows above the next input block);
- message boundaries are witness bits: `snew` (this perm starts a new
  message, forced = previous perm's is_final) and `is_final` (padding
  completes here); rate binding is
  input = snew ? block : prev_out XOR block, capacity = snew ? 0 : prev;
- keccak pad10*1 is constrained per byte with 8 monotonic padding flags
  per input row (the reference's is_paddings, keccak_packed_multi);
- the running input RLC (keccak_input challenge, phase-1 columns: 8 lanes,
  one per byte of the row), running unpadded length, and digest-word RLC
  (evm_word) accumulate along the same rows, and the last row of each
  permutation is the KeccakTable surface: (is_final, input_rlc,
  input_len, output_rlc) as selector-gated rotations — no extra columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from zkevm_tpu_torch.circuits.keccak_circuit import (
    BLOCK,
    INPUT_ROWS,
    ROUNDS,
    TOTAL_ROWS,
    _xor2,
    _xor5,
)
from zkevm_tpu_torch.circuits.tables import Challenges, KeccakTable
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.hash.keccak import _RC, _ROT
from zkevm_tpu_torch.plonk.assign import Assignment
from zkevm_tpu_torch.plonk.cs import Column, ColumnGroup, ConstraintSystem
from zkevm_tpu_torch.plonk.expr import Const, Expr, GroupQuery

PERM = TOTAL_ROWS  # 1825 rows per permutation
RATE = 136  # bytes absorbed per permutation
DIGEST_ROW0 = INPUT_ROWS + (ROUNDS - 1) * BLOCK + 50  # 1800
TABLE_ROW = PERM - 1  # 1824


@dataclass
class KeccakTableConfig:
    bits: ColumnGroup  # 64: working state bits
    ablock: ColumnGroup  # 64: absorbed rate-block bits (incl. padding)
    pads: ColumnGroup  # 8: per-byte padding flags on rate rows
    rc: ColumnGroup  # 64 fixed: iota constants
    rlc8: ColumnGroup  # 8 phase-1: running input RLC after each byte
    snew: Column  # starts-new-message flag (smeared over input rows)
    is_final: Column  # padding-completes-here flag (smeared)
    dlen: Column  # running unpadded length
    orlc: Column  # phase-1 running digest RLC
    # fixed selectors
    q_in: Column  # input rows 0..24
    q_in_gt0: Column  # input rows 1..24
    q_rate: Column  # input rows 0..16
    q_rate_gt0: Column  # input rows 1..16
    q_row0: Column
    q_row16: Column
    q_perm0: Column  # row 0 of permutation 0 only
    q_digest0: Column  # row 1800
    q_digest_gt0: Column  # rows 1801..1803
    q_table: Column  # row 1824 of each permutation
    q_c: list
    q_a: list
    q_o: list
    table: KeccakTable
    challenges: Challenges


def _byte_expr(group: ColumnGroup, j: int, rot: int = 0) -> Expr:
    """Byte j (0..7) of a 64-bit lane row: sum 2^(z-8j) * bit_z."""
    acc = Const(0)
    for z in range(8 * j, 8 * j + 8):
        acc = acc + Const(1 << (z - 8 * j)) * group.columns[z].rot(rot)
    return acc


def configure(cs: ConstraintSystem, challenges: Challenges) -> KeccakTableConfig:
    bits = cs.advice_group("kbits", 64)
    ablock = cs.advice_group("kablock", 64)
    pads = cs.advice_group("kpads", 8)
    rc = cs.fixed_group("krc", 64)
    rlc8 = cs.advice_group("krlc8", 8, phase=1)
    snew = cs.advice_column()
    is_final = cs.advice_column()
    dlen = cs.advice_column()
    orlc = cs.advice_column(phase=1)
    q_in = cs.fixed_column()
    q_in_gt0 = cs.fixed_column()
    q_rate = cs.fixed_column()
    q_rate_gt0 = cs.fixed_column()
    q_row0 = cs.fixed_column()
    q_row16 = cs.fixed_column()
    q_perm0 = cs.fixed_column()
    q_digest0 = cs.fixed_column()
    q_digest_gt0 = cs.fixed_column()
    q_table = cs.fixed_column()
    q_c = [cs.fixed_column() for _ in range(5)]
    q_a = [cs.fixed_column() for _ in range(3)]
    q_o = [cs.fixed_column() for _ in range(25)]

    one = Const(1)
    B = bits.q
    A = ablock.q

    # -- permutation core (identical math to keccak_circuit.configure) ---
    for y in range(5):
        ops = [B(-25 + 5 * (yp - y)) for yp in range(5)]
        cs.create_vector_gate(f"kt_theta_c_y{y}", q_c[y].cur() * (_xor5(ops) - B()), 64)
    for qi, (rot_m1, rot_p1) in enumerate([(-21, -24), (-26, -24), (-26, -29)]):
        expr = _xor2(_xor2(B(-50), B(rot_m1)), GroupQuery(bits, rot_p1, 1)) - B()
        cs.create_vector_gate(f"kt_theta_aprime_{qi}", q_a[qi].cur() * expr, 64)

    def b_operand(u: int, y: int, l_out: int) -> GroupQuery:
        yp = u
        up = (3 * (y - 3 * u)) % 5
        l_src = up + 5 * yp
        rot = l_src - l_out - 25
        roll = _ROT[5 * yp + up]
        return GroupQuery(bits, rot, roll)

    for l in range(25):
        x, y = l % 5, l // 5
        b0 = b_operand(x, y, l)
        b1 = b_operand((x + 1) % 5, y, l)
        b2 = b_operand((x + 2) % 5, y, l)
        chi = b0 + (one - b1) * b2 * (one - Const(2) * b0)
        if l == 0:
            rcq = rc.q()
            out_val = chi + rcq - Const(2) * chi * rcq
        else:
            out_val = chi
        cs.create_vector_gate(f"kt_chi_l{l}", q_o[l].cur() * (out_val - B()), 64)

    # -- sponge chaining (prev perm OUT lane l is at rotation -25) -------
    cs.create_vector_gate("kt_in_bool", q_in.cur() * B() * (B() - one), 64)
    cs.create_vector_gate("kt_ablock_bool", q_rate.cur() * A() * (A() - one), 64)
    s = snew.cur()
    P = B(-25)
    absorbed = s * A() + (one - s) * (P + A() - Const(2) * P * A())
    cs.create_vector_gate("kt_rate_bind", q_rate.cur() * (B() - absorbed), 64)
    cs.create_vector_gate(
        "kt_capacity_bind",
        (q_in.cur() - q_rate.cur()) * (B() - (one - s) * P),
        64,
    )

    # -- message-boundary flags ------------------------------------------
    fin = is_final.cur()
    cs.create_gate(
        "kt_flags",
        [
            q_in.cur() * s * (one - s),
            q_in.cur() * fin * (one - fin),
            q_in_gt0.cur() * (s - snew.prev()),
            q_in_gt0.cur() * (fin - is_final.prev()),
            q_perm0.cur() * (s - one),
            # non-first perms: snew = previous perm's is_final (its last
            # input row, 24, sits 1801 rows above this row 0)
            (q_row0.cur() - q_perm0.cur()) * (s - is_final.rot(-1801)),
            # padding must complete exactly on final perms
            q_row16.cur() * (pads.columns[7].cur() - fin),
        ],
    )

    # -- pad10*1 flags and bytes (keccak_packed_multi is_paddings) -------
    p = [pads.columns[j] for j in range(8)]
    flag_gates = []
    for j in range(8):
        flag_gates.append(q_rate.cur() * p[j].cur() * (one - p[j].cur()))
        flag_gates.append(q_rate.cur() * p[j].cur() * (one - fin))
    for j in range(1, 8):
        d = p[j].cur() - p[j - 1].cur()
        flag_gates.append(q_rate.cur() * d * (one - d))
    d0 = p[0].cur() - p[7].prev()
    flag_gates.append(q_rate_gt0.cur() * d0 * (one - d0))
    cs.create_gate("kt_pad_flags", flag_gates)

    byte_gates = []
    for j in range(8):
        bj = _byte_expr(ablock, j)
        if j == 0:
            # rows > 0: previous flag is byte 7 of the previous row;
            # row 0: padding never spans permutations, so prev flag = 0
            byte_gates.append(
                q_rate_gt0.cur() * (p[0].cur() * bj - (p[0].cur() - p[7].prev()))
            )
            byte_gates.append(q_row0.cur() * (p[0].cur() * bj - p[0].cur()))
        else:
            e = p[j].cur() * bj - (p[j].cur() - p[j - 1].cur())
            if j == 7:
                byte_gates.append(
                    q_rate.cur() * e - q_row16.cur() * p[7].cur() * Const(0x80)
                )
            else:
                byte_gates.append(q_rate.cur() * e)
    cs.create_gate("kt_pad_bytes", byte_gates)

    # -- running input RLC (phase 1) + unpadded length -------------------
    r = challenges.keccak_input.expr()
    v = [rlc8.columns[j] for j in range(8)]
    rlc_gates = []
    for j in range(1, 8):
        prev = v[j - 1].cur()
        bj = _byte_expr(ablock, j)
        step = p[j].cur() * prev + (one - p[j].cur()) * (prev * r + bj)
        rlc_gates.append(q_rate.cur() * (v[j].cur() - step))
    b0 = _byte_expr(ablock, 0)
    prev_row = v[7].prev()
    step = p[0].cur() * prev_row + (one - p[0].cur()) * (prev_row * r + b0)
    rlc_gates.append(q_rate_gt0.cur() * (v[0].cur() - step))
    # perm row 0: carry from the previous perm's row 16 (1809 rows above)
    # unless this perm starts a new message
    carry = (one - s) * v[7].rot(-1809)
    step0 = p[0].cur() * carry + (one - p[0].cur()) * (carry * r + b0)
    rlc_gates.append(q_row0.cur() * (v[0].cur() - step0))
    cs.create_gate("kt_input_rlc", rlc_gates)

    npad = Const(0)
    for j in range(8):
        npad = npad + p[j].cur()
    got = Const(8) - npad
    cs.create_gate(
        "kt_input_len",
        [
            q_rate_gt0.cur() * (dlen.cur() - dlen.prev() - got),
            q_row0.cur() * (dlen.cur() - (one - s) * dlen.rot(-1809) - got),
        ],
    )

    # -- digest word RLC (phase 1, evm_word) -----------------------------
    rw = challenges.evm_word.expr()
    def digest_fold(prev: Expr) -> Expr:
        acc = prev
        for j in range(8):
            acc = acc * rw + _byte_expr(bits, j)
        return acc

    cs.create_gate(
        "kt_output_rlc",
        [
            q_digest0.cur() * (orlc.cur() - digest_fold(Const(0))),
            q_digest_gt0.cur() * (orlc.cur() - digest_fold(orlc.prev())),
        ],
    )

    # -- the KeccakTable surface (last row of each permutation) ----------
    # digest (lo, hi) halves as expressions over the output-state bit rows:
    # digest byte i = byte (i%8) of output lane (i//8), big-endian integer
    # convention (digest[0] most significant). No extra columns needed.
    def digest_half(lanes, top_i):
        acc = Const(0)
        for l in lanes:
            rot = -(TABLE_ROW - (DIGEST_ROW0 + l))
            for j in range(8):
                i = 8 * l + j
                acc = acc + Const(1 << (8 * (top_i - i))) * _byte_expr(bits, j, rot)
        return acc

    table = KeccakTable(
        enabled=q_table.cur() * is_final.rot(-(TABLE_ROW - 24)),
        input_rlc=q_table.cur() * rlc8.columns[7].rot(-(TABLE_ROW - 16)),
        input_len=q_table.cur() * dlen.rot(-(TABLE_ROW - 16)),
        output_rlc=q_table.cur() * orlc.rot(-(TABLE_ROW - (DIGEST_ROW0 + 3))),
        output_lo=q_table.cur() * digest_half([2, 3], 31),
        output_hi=q_table.cur() * digest_half([0, 1], 15),
    )

    return KeccakTableConfig(
        bits, ablock, pads, rc, rlc8, snew, is_final, dlen, orlc,
        q_in, q_in_gt0, q_rate, q_rate_gt0, q_row0, q_row16, q_perm0,
        q_digest0, q_digest_gt0, q_table, q_c, q_a, q_o, table, challenges,
    )


def num_perms(cs: ConstraintSystem, n: int) -> int:
    return cs.usable_rows(n) // PERM


def assign_fixed(
    cs: ConstraintSystem, cfg: KeccakTableConfig, n: int, asg: Assignment | None = None
) -> Assignment:
    asg = asg if asg is not None else Assignment(cs, n)
    one = FR.encode(1)
    for pi in range(num_perms(cs, n)):
        base = pi * PERM
        asg.cols[cfg.q_in][base : base + 25] = one
        asg.cols[cfg.q_in_gt0][base + 1 : base + 25] = one
        asg.cols[cfg.q_rate][base : base + 17] = one
        asg.cols[cfg.q_rate_gt0][base + 1 : base + 17] = one
        asg.cols[cfg.q_row0][base] = one
        asg.cols[cfg.q_row16][base + 16] = one
        if pi == 0:
            asg.cols[cfg.q_perm0][base] = one
        asg.cols[cfg.q_digest0][base + DIGEST_ROW0] = one
        asg.cols[cfg.q_digest_gt0][base + DIGEST_ROW0 + 1 : base + DIGEST_ROW0 + 4] = one
        asg.cols[cfg.q_table][base + TABLE_ROW] = one
        for rd in range(ROUNDS):
            rbase = base + INPUT_ROWS + rd * BLOCK
            for l in range(25):
                y, x = l // 5, l % 5
                asg.cols[cfg.q_c[y]][rbase + l] = one
                qa = 0 if x == 0 else (2 if x == 4 else 1)
                asg.cols[cfg.q_a[qa]][rbase + 25 + l] = one
                asg.cols[cfg.q_o[l]][rbase + 50 + l] = one
            rc_val = _RC[rd]
            for z in range(64):
                if (rc_val >> z) & 1:
                    asg.cols[cfg.rc.columns[z]][rbase + 50] = one
    return asg


def _perm_rows(state_in: list, block_lanes: list) -> tuple:
    """One keccak-f from state_in ^ block -> (rows (PERM, 64) uint8 with
    the table row left zero, state_out lanes)."""
    rows = np.zeros((PERM, 64), dtype=np.uint8)
    a = [state_in[l] ^ (block_lanes[l] if l < 17 else 0) for l in range(25)]

    def bits_of(vv):
        return [(vv >> z) & 1 for z in range(64)]

    for l in range(25):
        rows[l] = bits_of(a[l])
    rot64 = lambda vv, rr: ((vv << rr) | (vv >> (64 - rr))) & ((1 << 64) - 1)
    for rd in range(ROUNDS):
        base = INPUT_ROWS + rd * BLOCK
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        for l in range(25):
            rows[base + l] = bits_of(c[l % 5])
        ap = [0] * 25
        for l in range(25):
            x, y = l % 5, l // 5
            ap[l] = a[l] ^ c[(x - 1) % 5] ^ rot64(c[(x + 1) % 5], 1)
            rows[base + 25 + l] = bits_of(ap[l])
        b = [0] * 25
        for y in range(5):
            for x in range(5):
                nx, ny = y, (2 * x + 3 * y) % 5
                b[5 * ny + nx] = rot64(ap[5 * y + x], _ROT[5 * y + x])
        out = [0] * 25
        for l in range(25):
            x, y = l % 5, l // 5
            out[l] = b[l] ^ ((~b[5 * y + (x + 1) % 5]) & b[5 * y + (x + 2) % 5] & ((1 << 64) - 1))
        out[0] ^= _RC[rd]
        for l in range(25):
            rows[base + 50 + l] = bits_of(out[l])
        a = out
    return rows, a


@dataclass
class KeccakWitness:
    """Phase-0 assignment + the data needed to fill phase-1 RLC columns
    once challenges are known."""

    asg: Assignment
    cfg: KeccakTableConfig
    n: int
    byte_rows: np.ndarray  # (num_perms*17, 8) absorbed bytes per rate row
    pad_rows: np.ndarray  # (num_perms*17, 8) padding flags
    snew_perms: list  # per perm
    digest_bytes: np.ndarray  # (num_perms, 32)

    def fill_phase1(self, r_keccak: int, r_word: int) -> None:
        """Compute rlc8/orlc columns for the given challenge values."""
        cfg, asg = self.cfg, self.asg
        nperm = len(self.snew_perms)
        acc = 0
        for pi in range(nperm):
            base = pi * PERM
            if self.snew_perms[pi]:
                acc = 0
            for l in range(17):
                ri = pi * 17 + l
                for j in range(8):
                    if not self.pad_rows[ri, j]:
                        acc = (acc * r_keccak + int(self.byte_rows[ri, j])) % FR_MOD
                    asg.set_int(cfg.rlc8.columns[j], base + l, acc)
            oacc = 0
            for l in range(4):
                for j in range(8):
                    oacc = (oacc * r_word + int(self.digest_bytes[pi, 8 * l + j])) % FR_MOD
                asg.set_int(cfg.orlc, base + DIGEST_ROW0 + l, oacc)

    def witness_phases(self):
        """create_proof witness callback: phase 0 returns the raw advice,
        phase 1 computes the RLC columns from the transcript challenges."""
        cfg = self.cfg

        def cb(phase: int, ch: dict) -> dict:
            if phase == 1:
                self.fill_phase1(
                    ch[cfg.challenges.keccak_input], ch[cfg.challenges.evm_word]
                )
            return {
                c: self.asg.cols[c]
                for c in self.asg.cs.advice_columns
                if c.phase == phase
            }

        return cb


def assign(
    cs: ConstraintSystem,
    cfg: KeccakTableConfig,
    n: int,
    messages: list[bytes],
    asg: Assignment | None = None,
) -> KeccakWitness:
    """Pack the messages' sponge permutations into the layout (phase-0
    columns); phase-1 RLCs are filled by KeccakWitness once challenges
    exist (mock: pseudo-challenges; prover: transcript challenges).
    Pass `asg` to compose into a shared assignment (SuperCircuit-style)."""
    nperm = num_perms(cs, n)
    asg = assign_fixed(cs, cfg, n, asg)
    one = FR.encode(1)

    # plan permutations: (message, block_bytes (136,), pads (136,), snew, fin)
    plan = []
    for msg in messages:
        nblocks = len(msg) // RATE + 1
        for bi in range(nblocks):
            chunk = msg[bi * RATE : (bi + 1) * RATE]
            blk = bytearray(chunk)
            padflags = [0] * RATE
            if bi == nblocks - 1:
                rem = len(chunk)
                blk += b"\x00" * (RATE - rem)
                blk[rem] |= 0x01
                blk[RATE - 1] |= 0x80
                for bpos in range(rem, RATE):
                    padflags[bpos] = 1
            plan.append((bytes(blk), padflags, 1 if bi == 0 else 0, 1 if bi == nblocks - 1 else 0))
    assert len(plan) <= nperm, f"{len(plan)} blocks > {nperm} perms (raise k)"
    while len(plan) < nperm:
        # unused perms: zero block, new-"message" after a final perm /
        # continuation of the zero chain afterwards
        prev_fin = plan[-1][3] if plan else 1
        plan.append((b"\x00" * RATE, [0] * RATE, prev_fin, 0))

    byte_rows = np.zeros((nperm * 17, 8), dtype=np.uint16)
    pad_rows = np.zeros((nperm * 17, 8), dtype=np.uint8)
    digest_bytes = np.zeros((nperm, 32), dtype=np.uint16)
    snew_perms = []

    bits_cols = np.zeros((64, n), dtype=bool)
    ablock_cols = np.zeros((64, n), dtype=bool)

    state = [0] * 25
    dlen_acc = 0
    for pi, (blk, padflags, snew_v, fin_v) in enumerate(plan):
        base = pi * PERM
        if snew_v:
            state = [0] * 25
            dlen_acc = 0
        snew_perms.append(snew_v)
        block_lanes = [
            int.from_bytes(blk[8 * l : 8 * l + 8], "little") for l in range(17)
        ]
        rows, state = _perm_rows(state, block_lanes)
        for z in range(64):
            nz = np.nonzero(rows[:, z])[0]
            bits_cols[z, base + nz] = True
        # ablock bits on rate rows
        for l in range(17):
            lane = block_lanes[l]
            for z in range(64):
                if (lane >> z) & 1:
                    ablock_cols[z, base + l] = True
        # flags + dlen
        for l in range(25):
            asg.cols[cfg.snew][base + l] = one if snew_v else 0
            asg.cols[cfg.is_final][base + l] = one if fin_v else 0
        for l in range(17):
            ri = pi * 17 + l
            for j in range(8):
                bpos = 8 * l + j
                byte_rows[ri, j] = blk[bpos]
                pad_rows[ri, j] = padflags[bpos]
                if padflags[bpos]:
                    asg.cols[cfg.pads.columns[j]][base + l] = one
                else:
                    dlen_acc += 1
            asg.set_int(cfg.dlen, base + l, dlen_acc)
        # digest = first 32 bytes of the OUTPUT state
        dig = b"".join(int.to_bytes(state[l], 8, "little") for l in range(4))
        digest_bytes[pi] = np.frombuffer(dig, dtype=np.uint8)

    for z in range(64):
        col = np.zeros((n, ff.W), dtype=np.uint32)
        col[bits_cols[z]] = one
        asg.cols[cfg.bits.columns[z]] = col
        col = np.zeros((n, ff.W), dtype=np.uint32)
        col[ablock_cols[z]] = one
        asg.cols[cfg.ablock.columns[z]] = col

    return KeccakWitness(asg, cfg, n, byte_rows, pad_rows, snew_perms, digest_bytes)
