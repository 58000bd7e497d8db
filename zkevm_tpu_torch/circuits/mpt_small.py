"""The small state-trie case shared by the port's tests, the smoke run and
the reference-vector script.

The MPT circuit over the PoseidonTable (``tests/test_mpt_circuit.py`` of
the reference) at trie depth 8 and the smallest k whose table holds its
witness (k=12): a trie with one entry, then two chained updates, an insert
of a new key and an update of the existing one. ``TAMPERS`` are that
test's four forged witnesses. Everything is written against the API that
the port shares with the reference (``ConstraintSystem``, ``ZkTrie``,
``Assignment.get_int`` / ``set_int``, the circuits' ``configure`` and
``apply_update``), so passing a package's classes and modules builds the
same case in that package.
"""

from __future__ import annotations

from zkevm_tpu_torch.circuits.mpt_circuit import KEY_BITS

DEPTH = 8
K = 12
N = 1 << K
SEED = 5  # the blinding seed of the recorded proof


def build(ConstraintSystem, pt, mpt, depth: int = DEPTH):
    """-> (cs, PoseidonTable config, MPT config)."""
    cs = ConstraintSystem()
    ptcfg = pt.configure(cs)
    mcfg = mpt.configure(cs, ptcfg.table, depth=depth)
    return cs, ptcfg, mcfg


def updates(ZkTrie, mpt, depth: int = DEPTH) -> list:
    """A pre-filled trie, then an insert and a chained update."""
    trie = ZkTrie(depth=depth)
    trie.update([0xAAAA, 5], [111, 0])  # pre-existing entry
    u1 = mpt.apply_update(trie, 0xBBBB, 7, 222, 1)  # insert
    u2 = mpt.apply_update(trie, 0xAAAA, 5, 333, 0)  # update
    return [u1, u2]


def _flip_root_new(asg, mcfg, depth):
    row = KEY_BITS + depth - 1  # root row of update 2
    asg.set_int(mcfg.root_new, row, asg.get_int(mcfg.root_new, row) ^ 1)


def _forge_value(asg, mcfg, depth):
    """Claim a different new value without recomputing hashes."""
    asg.set_int(mcfg.vlo_new, KEY_BITS, 334)  # update 2's leaf row


def _flip_path_bit(asg, mcfg, depth):
    """Move the leaf to a different path: the kh binding must break."""
    row = KEY_BITS + 3  # level 3 of update 2
    asg.set_int(mcfg.bit, row, 1 - asg.get_int(mcfg.bit, row))


def _break_chain(asg, mcfg, depth):
    """The second update starts from a different root."""
    row = KEY_BITS + depth - 1
    asg.set_int(mcfg.root_old, row, asg.get_int(mcfg.root_old, row) ^ 1)


TAMPERS = {
    "forged_new_root": _flip_root_new,
    "forged_value": _forge_value,
    "forged_path_bit": _flip_path_bit,
    "broken_chain": _break_chain,
}


def failures_to_json(failures) -> list:
    """MockProver failures (either package's) as JSON-ready lists."""
    return [[f.kind, f.name, int(f.index), [int(r) for r in f.rows]] for f in failures]
