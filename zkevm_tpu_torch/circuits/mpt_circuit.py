"""MPT circuit: in-circuit zktrie update proofs against the PoseidonTable.

Port of ``zkevm_tpu/circuits/mpt_circuit.py``: the same columns, gates,
lookups and MptTable surface (copied), proving statements of the form

    root_old --[key (k0,k1): value_old -> value_new]--> root_new

for the sparse binary Poseidon trie of ``state/zktrie.py``:

    leaf  = H(kh, vh, 2^64*1)      kh = H(k0, k1, 2^64*2)
    node  = H(left, right, 2^64*2)  vh = H(v_lo, v_hi, 2^64*2)

with the path given by the low ``depth`` bits of kh (LSB at leaf level).
One update occupies ``KEY_BITS`` rows: ``depth`` folding levels (leaf
first) and the high key bits, with the full canonical 254-bit key
decomposition.

The witness differs from the reference's in how, not what, it is made:
every Poseidon hash of the updates' paths runs on the device through
kernel E, level by level across all updates (``_path_hashes``: one sponge
launch for the value hashes, one permutation launch for the leaves, then
one launch per level), where the reference calls the golden permutation
once per node in Python, twice over (in ``poseidon_states`` and in
``assign``). ``poseidon_states`` returns the reference's list, in its
order; ``assign`` fills the same cells, tiling the fixed columns'
254-row pattern over the slots.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from zkevm_tpu_torch.circuits.poseidon_table import PoseidonTable
from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.hash import poseidon as pos
from zkevm_tpu_torch.plonk.assign import Assignment
from zkevm_tpu_torch.plonk.cs import Column, ConstraintSystem
from zkevm_tpu_torch.plonk.expr import Const
from zkevm_tpu_torch.state.zktrie import ZkTrie

SPEC = pos.P128_POW5_T3
CAP_LEAF = (1 << 64) * 1 % FR_MOD
CAP_2 = (1 << 64) * 2 % FR_MOD
KEY_BITS = 254  # ceil(log2 p)


@dataclass
class MptTable:
    """(enabled, k0, k1, vlo_old, vhi_old, vlo_new, vhi_new, root_old,
    root_new) — one row per proven update (table.rs:784 MptTable)."""

    exprs: list

    def lookup(self, cs: ConstraintSystem, name: str, inputs: list) -> None:
        assert len(inputs) == len(self.exprs)
        cs.lookup(name, list(zip(inputs, self.exprs)))


@dataclass
class MptConfig:
    depth: int
    q_lvl: Column  # every update row
    q_leaf: Column
    q_root: Column
    q_fold: Column  # level rows whose parent is the next row
    q_chain: Column  # root rows with a following chained update
    pbit: Column  # fixed: bit i of the field modulus p
    pw: Column  # fixed: 2^i at level row i
    act: Column  # update-in-use flag (carried)
    bit: Column
    sib: Column
    nd_old: Column  # node hash at this height (old tree)
    nd_new: Column
    pacc: Column  # downward path accumulator (bits i..253)
    e: Column  # still-equal-to-p chain (canonicality)
    q_top: Column  # fixed: the region's top (bit-253) row
    kh: Column  # leaf row cells
    k0: Column
    k1: Column
    vh_old: Column
    vh_new: Column
    vlo_old: Column
    vhi_old: Column
    vlo_new: Column
    vhi_new: Column
    is_ins: Column
    root_old: Column  # root row cells
    root_new: Column
    table: MptTable


def configure(cs: ConstraintSystem, pt: PoseidonTable,
              depth: int = 248) -> MptConfig:
    nhi = KEY_BITS - depth
    assert 0 < nhi and depth >= 8
    # One update region spans KEY_BITS rows regardless of depth: the low
    # `depth` rows are hash-folding path levels; the high `nhi` rows
    # carry only the remaining key bits (bit/pacc/e chains, no folds).
    # This keeps the full 254-bit canonical key decomposition at ANY
    # trie depth — shallow tries (test harnesses, and eventually the
    # compressed scroll-style trie) just skip the fold lookups.
    q_lvl = cs.fixed_column()
    q_leaf = cs.fixed_column()
    q_root = cs.fixed_column()
    q_fold = cs.fixed_column()
    q_top = cs.fixed_column()  # the region's last (bit-253) row
    q_chain = cs.fixed_column()
    pbit = cs.fixed_column()
    pw = cs.fixed_column()
    act = cs.advice_column()
    bit = cs.advice_column()
    sib = cs.advice_column()
    nd_old = cs.advice_column()
    nd_new = cs.advice_column()
    pacc = cs.advice_column()
    e = cs.advice_column()
    (kh, k0, k1, vh_old, vh_new, vlo_old, vhi_old, vlo_new, vhi_new,
     is_ins, root_old, root_new) = [cs.advice_column() for _ in range(12)]

    one = Const(1)
    ql, qf, qr, qn = q_lvl.cur(), q_leaf.cur(), q_root.cur(), q_fold.cur()
    qt_ = q_top.cur()
    a = act.cur()
    b = bit.cur()

    # -- structure --------------------------------------------------------
    cs.create_gate("mpt_struct", [
        ql * a * (one - a),
        (ql - qf) * (a - act.prev()),
        ql * b * (one - b),
        qf * is_ins.cur() * (one - is_ins.cur()),
    ])

    # -- path accumulator + canonical decomposition ----------------------
    pb = pbit.cur()
    bn, pn = bit.rot(1), pbit.rot(1)
    eq_next = bn * pn + (one - bn) * (one - pn)
    eq_cur = b * pb + (one - b) * (one - pb)
    cs.create_gate("mpt_canon_chain", [
        # e(row i) = "key bits 253..i+1 all equal p's"; the top row
        # starts the chain with its own bit's equality folded below
        qt_ * a * (e.cur() - one),
        (ql - qt_) * (e.cur() - e.rot(1) * eq_next),
        # while still equal above, this row's bit may not exceed p's
        ql * e.cur() * b * (one - pb),
        # full equality with p (key == p == 0 wrapped) is not canonical
        qf * e.cur() * eq_cur,
    ])
    cs.create_gate("mpt_path", [
        qt_ * (pacc.cur() - pw.cur() * b),
        (ql - qt_) * (pacc.cur() - pacc.rot(1) - pw.cur() * b),
        qf * (pacc.cur() - kh.cur()),
    ])

    # -- fold lookups -----------------------------------------------------
    CAPL, CAP2 = Const(CAP_LEAF), Const(CAP_2)
    for nm, nd in (("old", nd_old), ("new", nd_new)):
        l_e = (one - b) * nd.cur() + b * sib.cur()
        r_e = b * nd.cur() + (one - b) * sib.cur()
        pt.lookup(cs, f"mpt_fold_{nm}", qn * a, l_e, r_e, CAP2, nd.rot(1))
        pt.lookup(
            cs, f"mpt_root_{nm}", qr * a, l_e, r_e, CAP2,
            (root_old if nm == "old" else root_new).cur(),
        )

    # -- leaf bindings ----------------------------------------------------
    qa = qf * a
    ins = is_ins.cur()
    pt.lookup(cs, "mpt_kh", qa, k0.cur(), k1.cur(), CAP2, kh.cur())
    pt.lookup(cs, "mpt_vh_new", qa, vlo_new.cur(), vhi_new.cur(), CAP2,
              vh_new.cur())
    pt.lookup(cs, "mpt_leaf_new", qa, kh.cur(), vh_new.cur(), CAPL,
              nd_new.cur())
    upd = qa * (one - ins)
    pt.lookup(cs, "mpt_vh_old", upd, vlo_old.cur(), vhi_old.cur(), CAP2,
              vh_old.cur())
    pt.lookup(cs, "mpt_leaf_old", upd, kh.cur(), vh_old.cur(), CAPL,
              nd_old.cur())
    cs.create_gate("mpt_insert", [
        qa * ins * nd_old.cur(),
        qa * ins * vh_old.cur(),
        qa * ins * vlo_old.cur(),
        qa * ins * vhi_old.cur(),
    ])

    # -- chained updates: next update starts from this root ---------------
    D = depth
    cs.create_gate("mpt_chain", [
        q_chain.cur() * (root_old.rot(KEY_BITS) - root_new.cur()),
    ])

    # -- MptTable surface -------------------------------------------------
    en = qr * a
    lrot = -(D - 1)  # leaf row from the root row
    table = MptTable([
        en,
        en * k0.rot(lrot),
        en * k1.rot(lrot),
        en * vlo_old.rot(lrot),
        en * vhi_old.rot(lrot),
        en * vlo_new.rot(lrot),
        en * vhi_new.rot(lrot),
        en * root_old.cur(),
        en * root_new.cur(),
    ])

    return MptConfig(
        depth, q_lvl, q_leaf, q_root, q_fold, q_chain, pbit, pw, act, bit,
        sib, nd_old, nd_new, pacc, e, q_top, kh, k0, k1, vh_old, vh_new,
        vlo_old, vhi_old, vlo_new, vhi_new, is_ins, root_old, root_new,
        table,
    )


def capacity(cs: ConstraintSystem, n: int, depth: int = 248) -> int:
    return cs.usable_rows(n) // KEY_BITS


@dataclass
class MptUpdate:
    """One applied update (witness record)."""

    k0: int
    k1: int
    v_old: tuple | None  # (lo, hi) or None for insertion
    v_new: tuple
    kh: int
    siblings: list  # leaf-level first
    root_old: int
    root_new: int


def apply_update(trie: ZkTrie, k0: int, k1: int, v_lo: int,
                 v_hi: int) -> MptUpdate:
    """Apply (k0,k1) <- (v_lo,v_hi) to the host trie, capturing the
    circuit witness (siblings are shared pre/post since only the leaf
    changes)."""
    root_old = trie.root
    old = trie.get([k0, k1])
    proof = trie.prove([k0, k1])
    root_new = trie.update([k0, k1], [v_lo, v_hi])
    sibs = list(reversed(proof.siblings))  # leaf-level first
    return MptUpdate(
        k0=k0, k1=k1,
        v_old=None if old is None else (old[0], old[1]),
        v_new=(v_lo, v_hi), kh=proof.key_hash, siblings=sibs,
        root_old=root_old, root_new=root_new,
    )


@dataclass
class _PathHashes:
    """Every hash of a batch of updates' witness, as ints."""

    vh_new: list  # per update
    vh_old: list  # per update, None for an insertion
    nd_old: list  # per update: the old tree's node at levels 0..depth
    nd_new: list  # (level 0: the leaf, level depth: the root)
    levels: list  # per level: the [l, r, CAP_2] states, update-major, old then new


def _lane0(states: list, dev) -> list[int]:
    """First output lane of the permutation of each [a, b, c] state."""
    if not states:
        return []
    words = FR.encode_many([v for s in states for v in s]).reshape(len(states), 3, ff.W)
    out = pos.permute(SPEC, ff.to_tensor(words, dev))
    return FR.decode_many(out[:, 0])


def _path_hashes(updates: list[MptUpdate], depth: int, dev) -> _PathHashes:
    """Hash every update's leaf and path on ``dev`` through kernel E: one
    sponge launch for the value hashes, one permutation launch for the
    leaves, then one launch per level over all updates (old and new tree)."""
    vals = [u.v_new for u in updates] + [u.v_old for u in updates if u.v_old is not None]
    vh = []
    if vals:
        msgs = FR.encode_many([v for pair in vals for v in pair]).reshape(len(vals), 2, ff.W)
        vh = FR.decode_many(pos.hash_many(SPEC, ff.to_tensor(msgs, dev)))
    nu = len(updates)
    vh_new = vh[:nu]
    old_iter = iter(vh[nu:])
    vh_old = [None if u.v_old is None else next(old_iter) for u in updates]
    leaf_states = [[u.kh, vh_new[i], CAP_LEAF] for i, u in enumerate(updates)]
    leaf_states += [[u.kh, vh_old[i], CAP_LEAF] for i, u in enumerate(updates)
                    if u.v_old is not None]
    leaves = _lane0(leaf_states, dev)
    old_iter = iter(leaves[nu:])
    nd_new = [[leaves[i]] for i in range(nu)]
    nd_old = [[0 if u.v_old is None else next(old_iter)] for u in updates]
    levels = []
    for i in range(depth):
        states = []
        for j, u in enumerate(updates):
            bit = (u.kh >> i) & 1
            s = u.siblings[i]
            for nd in (nd_old[j][i], nd_new[j][i]):
                states.append([s, nd, CAP_2] if bit else [nd, s, CAP_2])
        out = _lane0(states, dev)
        for j in range(nu):
            nd_old[j].append(out[2 * j])
            nd_new[j].append(out[2 * j + 1])
        levels.append(states)
    for j, u in enumerate(updates):
        if nd_old[j][depth] != u.root_old or nd_new[j][depth] != u.root_new:
            raise ValueError(f"update {j}: the path does not hash to its roots")
    return _PathHashes(vh_new, vh_old, nd_old, nd_new, levels)


def poseidon_states(updates: list[MptUpdate], depth: int, *, device=None) -> list:
    """Every Poseidon permutation the lookups require, in the reference's
    order (hashed on ``device``, CUDA unless the caller asks for the CPU)."""
    hs = _path_hashes(updates, depth, resolve_device(device))
    states = []
    for j, u in enumerate(updates):
        states.append([u.k0, u.k1, CAP_2])
        states.append([u.v_new[0], u.v_new[1], CAP_2])
        states.append([u.kh, hs.vh_new[j], CAP_LEAF])
        if u.v_old is not None:
            states.append([u.v_old[0], u.v_old[1], CAP_2])
            states.append([u.kh, hs.vh_old[j], CAP_LEAF])
        for lv in hs.levels:
            states += lv[2 * j : 2 * j + 2]
    return states


def _region_pattern(cfg: MptConfig) -> dict:
    """The fixed columns of one KEY_BITS-row update region (q_chain aside):
    {column: (KEY_BITS, 8) words}."""
    D, R = cfg.depth, KEY_BITS
    one = FR.encode(1)
    pat = {c: np.zeros((R, ff.W), np.uint32)
           for c in (cfg.q_lvl, cfg.q_leaf, cfg.q_root, cfg.q_top, cfg.q_fold, cfg.pbit, cfg.pw)}
    pat[cfg.q_lvl][:] = one
    pat[cfg.q_leaf][0] = one
    pat[cfg.q_root][D - 1] = one
    pat[cfg.q_top][R - 1] = one
    pat[cfg.q_fold][: D - 1] = one
    pat[cfg.pbit][:] = FR.encode_many([(FR_MOD >> i) & 1 for i in range(R)])
    pat[cfg.pw][:] = FR.encode_many([(1 << i) % FR_MOD for i in range(R)])
    return pat


def assign(
    cs: ConstraintSystem,
    cfg: MptConfig,
    n: int,
    updates: list[MptUpdate],
    asg: Assignment | None = None,
    *,
    chained: bool = True,
    device=None,
) -> Assignment:
    """Fill the MPT columns for ``updates`` (path hashes on ``device``,
    CUDA unless the caller asks for the CPU)."""
    asg = asg if asg is not None else Assignment(cs, n)
    D = cfg.depth
    nslots = capacity(cs, n, D)
    if len(updates) > nslots:
        raise ValueError(f"{len(updates)} updates > {nslots} slots")
    hs = _path_hashes(updates, D, resolve_device(device))
    one = FR.encode(1)

    R = KEY_BITS  # region rows (path levels + high key-bit rows)
    for col, pat in _region_pattern(cfg).items():
        asg.cols[col][: nslots * R] = np.tile(pat, (nslots, 1))
    if chained:
        for slot in range(len(updates) - 1):
            asg.cols[cfg.q_chain][slot * R + D - 1] = one

    for slot, u in enumerate(updates):
        base = slot * R
        asg.cols[cfg.act][base : base + R] = one
        asg.set_int(cfg.kh, base, u.kh)
        asg.set_int(cfg.k0, base, u.k0)
        asg.set_int(cfg.k1, base, u.k1)
        asg.set_int(cfg.vh_new, base, hs.vh_new[slot])
        asg.set_int(cfg.vlo_new, base, u.v_new[0])
        asg.set_int(cfg.vhi_new, base, u.v_new[1])
        if u.v_old is None:
            asg.set_int(cfg.is_ins, base, 1)
        else:
            asg.set_int(cfg.vh_old, base, hs.vh_old[slot])
            asg.set_int(cfg.vlo_old, base, u.v_old[0])
            asg.set_int(cfg.vhi_old, base, u.v_old[1])

        # downward accumulators (pacc_i = bits i..253 of kh) and the
        # canonical-comparison chain over ALL key-bit rows
        pacc = [0] * (R + 1)
        for i in reversed(range(R)):
            pacc[i] = pacc[i + 1] + (((u.kh >> i) & 1) << i)
        e_vals = [0] * R
        still = True
        for i in reversed(range(R)):
            e_vals[i] = 1 if still else 0  # bits above row i equal p's
            if still:
                still = ((u.kh >> i) & 1) == ((FR_MOD >> i) & 1)

        asg.set_ints(cfg.bit, base, [(u.kh >> i) & 1 for i in range(R)])
        asg.set_ints(cfg.pacc, base, [pacc[i] % FR_MOD for i in range(R)])
        asg.set_ints(cfg.e, base, e_vals)
        asg.set_ints(cfg.sib, base, u.siblings[:D])
        asg.set_ints(cfg.nd_old, base, hs.nd_old[slot][:D])
        asg.set_ints(cfg.nd_new, base, hs.nd_new[slot][:D])
        asg.set_int(cfg.root_old, base + D - 1, u.root_old)
        asg.set_int(cfg.root_new, base + D - 1, u.root_new)
    return asg
