"""Sparse binary Poseidon Merkle trie (zktrie): a host copy.

Port of ``zkevm_tpu/state/zktrie.py`` (the reference's counterpart of
scroll-tech/zktrie, the authenticated state tree whose update proofs the
MPT circuit verifies), unchanged: python ints and the golden Poseidon.

- fixed-depth (default 248) sparse binary trie; empty subtrees hash to a
  per-level precomputed default;
- leaf hash      H(1, key_hash, value_hash)   (domain tag 1)
- branch hash    H(2, left, right)            (domain tag 2)
- value_hash     Poseidon sponge over the value field elements
- key_hash       Poseidon sponge of the key field element(s)

Merkle paths follow key_hash bits LSB-first from the root. The MPT
circuit's witness (``circuits/mpt_circuit.py``) re-hashes every update's
path in bulk through kernel E.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.hash import poseidon as pos

SPEC = pos.P128_POW5_T3
DEPTH_DEFAULT = 248

LEAF_TAG = 1
BRANCH_TAG = 2


def _h2(tag: int, a: int, b: int) -> int:
    """Domain-tagged 2-to-1 compression: one permutation with the tag in
    the capacity element."""
    state = [a % FR_MOD, b % FR_MOD, ((1 << 64) * tag) % FR_MOD]
    return pos.permute_golden(SPEC, state)[0]


def hash_fields(fields) -> int:
    """Sponge-hash a list of field elements (value/key hashing)."""
    return pos.hash_golden(SPEC, [f % FR_MOD for f in fields])


@lru_cache(maxsize=None)
def empty_hash(level: int) -> int:
    """Hash of an empty subtree whose root sits `level` levels above the
    leaves. Level 0 (empty leaf slot) is 0 by convention."""
    if level == 0:
        return 0
    child = empty_hash(level - 1)
    return _h2(BRANCH_TAG, child, child)


@dataclass
class Proof:
    key_hash: int
    value_hash: int  # 0 for non-inclusion
    siblings: list  # depth entries, root-side first


class ZkTrie:
    """Sparse Poseidon trie with per-key value-field lists."""

    def __init__(self, depth: int = DEPTH_DEFAULT):
        self.depth = depth
        self._leaves: dict[int, list] = {}  # key_hash -> value fields
        # internal node cache: {(level, prefix): hash}; prefix = path bits
        # from the root (level counts UP from leaves)
        self._nodes: dict[tuple, int] = {}

    # -- hashing helpers -------------------------------------------------
    def key_hash(self, key_fields) -> int:
        return hash_fields(list(key_fields))

    def _leaf_hash(self, kh: int) -> int:
        vals = self._leaves.get(kh)
        if vals is None:
            return 0
        return _h2(LEAF_TAG, kh, hash_fields(vals))

    def _node_hash(self, height: int, node_id: int) -> int:
        """Hash of the node at `height` (0 = leaf level) with id
        `node_id` = leaf_path >> height."""
        if height == 0:
            kh = self._id_leaf(node_id)
            return self._leaf_hash(kh) if kh is not None else 0
        cached = self._nodes.get((height, node_id))
        if cached is not None:
            return cached
        return empty_hash(height)

    def _id_leaf(self, node_id: int):
        for kh in self._leaves:
            if self._path(kh) == node_id:
                return kh
        return None

    def _path(self, kh: int) -> int:
        return kh & ((1 << self.depth) - 1)

    # -- operations ------------------------------------------------------
    @property
    def root(self) -> int:
        return self._node_hash(self.depth, 0)

    def get(self, key_fields):
        return self._leaves.get(self.key_hash(key_fields))

    def update(self, key_fields, value_fields) -> int:
        """Insert/update; returns the new root."""
        kh = self.key_hash(key_fields)
        if value_fields is None:
            self._leaves.pop(kh, None)
        else:
            self._leaves[kh] = [v % FR_MOD for v in value_fields]
        path = self._path(kh)
        # recompute the root path; bit (h-1) picks the branch from height h
        node = self._leaf_hash(kh) if value_fields is not None else 0
        for h in range(1, self.depth + 1):
            bit = (path >> (h - 1)) & 1
            sib = self._node_hash(h - 1, (path >> (h - 1)) ^ 1)
            node = _h2(BRANCH_TAG, node, sib) if bit == 0 else _h2(BRANCH_TAG, sib, node)
            self._nodes[(h, path >> h)] = node
        return node

    def prove(self, key_fields) -> Proof:
        kh = self.key_hash(key_fields)
        path = self._path(kh)
        sibs = []
        for h in range(self.depth, 0, -1):
            sibs.append(self._node_hash(h - 1, (path >> (h - 1)) ^ 1))
        vals = self._leaves.get(kh)
        vh = hash_fields(vals) if vals is not None else 0
        return Proof(kh, vh, sibs)

    def verify(self, proof: Proof, root: int) -> bool:
        node = _h2(LEAF_TAG, proof.key_hash, proof.value_hash) if proof.value_hash else 0
        path = self._path(proof.key_hash)
        for h in range(1, self.depth + 1):
            bit = (path >> (h - 1)) & 1
            sib = proof.siblings[self.depth - h]
            node = _h2(BRANCH_TAG, node, sib) if bit == 0 else _h2(BRANCH_TAG, sib, node)
        return node == root
