"""Proof / verifying-key artifacts: frozen byte format + cached resume.

A host copy of ``zkevm_tpu/prover/artifacts.py`` over the port's ``Proof``
and ``VerifyingKey``: the same bytes and the same fingerprint, so a proof
or a verifying-key identity written by either package reads in the other.

Reference counterparts of the original:
- proof JSON dump/load + vk bytes: prover/src/proof.rs:26-67,100-108
- per-layer `load_or_gen_*` snark caching (a killed job resumes from the
  last completed layer): prover/src/common/prover/inner.rs:41-67,
  zkevm/prover.rs:79-82.

Frozen proof wire format v1 (`ZKTPUPF1`) — little-endian throughout:

    magic[8] | n_advice u32 | n_lookup u32 | n_perm u32 | n_lookz u32 |
    n_h u32 | n_evals u32
    advice commitments   n_advice * 64 B   (G1: x||y, canonical 32 B LE)
    lookup permuted      n_lookup * 128 B  (a_comm || s_comm)
    perm z               n_perm * 64 B
    lookup z             n_lookz * 64 B
    random commitment    64 B
    h pieces             n_h * 64 B
    evals                n_evals * 32 B    (canonical Fr LE)
    shplonk h, w         2 * 64 B

This matches the transcript absorption order (plonk/prover.py), so a
serialized proof replays byte-for-byte. halo2-fork compressed-point
parity is tracked separately (SURVEY §7 hard part #2).
"""

from __future__ import annotations

import hashlib
import json
import os

from zkevm_tpu_torch.ff.goldens import FQ_MOD, FR_MOD
from zkevm_tpu_torch.plonk.keygen import VerifyingKey
from zkevm_tpu_torch.plonk.prover import Proof

MAGIC = b"ZKTPUPF1"


def _pt(p) -> bytes:
    if p is None:  # identity (to_affine_ints convention)
        return bytes(64)
    x, y = p
    if not (0 <= x < FQ_MOD and 0 <= y < FQ_MOD):
        raise ValueError("point coordinate out of range")
    return int(x).to_bytes(32, "little") + int(y).to_bytes(32, "little")


def _unpt(b: bytes):
    x = int.from_bytes(b[:32], "little")
    y = int.from_bytes(b[32:64], "little")
    if x == 0 and y == 0:
        return None
    if x >= FQ_MOD or y >= FQ_MOD:
        raise ValueError("non-canonical point bytes")
    return (x, y)


def proof_to_bytes(proof: Proof) -> bytes:
    out = [MAGIC]
    counts = [
        len(proof.advice_commitments),
        len(proof.lookup_permuted),
        len(proof.perm_z_commitments),
        len(proof.lookup_z_commitments),
        len(proof.h_commitments),
        len(proof.evals),
    ]
    out += [c.to_bytes(4, "little") for c in counts]
    out += [_pt(p) for p in proof.advice_commitments]
    out += [_pt(a) + _pt(s) for a, s in proof.lookup_permuted]
    out += [_pt(p) for p in proof.perm_z_commitments]
    out += [_pt(p) for p in proof.lookup_z_commitments]
    out.append(_pt(proof.random_commitment))
    out += [_pt(p) for p in proof.h_commitments]
    for e in proof.evals:
        if not 0 <= e < FR_MOD:
            raise ValueError("eval out of range")
        out.append(int(e).to_bytes(32, "little"))
    out.append(_pt(proof.shplonk_h))
    out.append(_pt(proof.shplonk_w))
    return b"".join(out)


def proof_from_bytes(data: bytes) -> Proof:
    if data[:8] != MAGIC:
        raise ValueError("bad proof magic")
    off = 8
    counts = []
    for _ in range(6):
        counts.append(int.from_bytes(data[off : off + 4], "little"))
        off += 4
    na, nl, np_, nz, nh, ne = counts
    expected = 8 + 24 + 64 * (na + 2 * nl + np_ + nz + 1 + nh + 2) + 32 * ne
    if len(data) != expected:
        raise ValueError(f"bad proof length {len(data)} (expected {expected})")

    def pts(count, width=64):
        nonlocal off
        vals = [data[off + i * width : off + (i + 1) * width] for i in range(count)]
        off += count * width
        return vals

    advice = [_unpt(b) for b in pts(na)]
    lookup = [(_unpt(b[:64]), _unpt(b[64:])) for b in pts(nl, 128)]
    perm_z = [_unpt(b) for b in pts(np_)]
    look_z = [_unpt(b) for b in pts(nz)]
    random_c = _unpt(pts(1)[0])
    hs = [_unpt(b) for b in pts(nh)]
    evals = []
    for b in pts(ne, 32):
        e = int.from_bytes(b, "little")
        if e >= FR_MOD:
            raise ValueError("non-canonical eval bytes")
        evals.append(e)
    sh = _unpt(pts(1)[0])
    sw = _unpt(pts(1)[0])
    return Proof(advice, lookup, perm_z, look_z, random_c, hs, evals, sh, sw)


def vk_fingerprint(vk: VerifyingKey) -> str:
    """Stable identity of (circuit shape, SRS-derived commitments) — the
    analog of the reference's pinned vk files (zkevm/prover.rs:26-39,
    vk-consistency checks :131-151)."""
    h = hashlib.sha256()
    cs = vk.cs
    h.update(
        json.dumps(
            {
                "k": vk.domain.k,
                "advice": [c.phase for c in cs.advice_columns],
                "fixed": len(cs.fixed_columns),
                "gates": [g.name for g in cs.gates],
                "lookups": [l.name for l in cs.lookups],
                "perm_cols": len(cs.permutation_columns),
            },
            sort_keys=True,
        ).encode()
    )
    for p in vk.fixed_commitments + vk.sigma_commitments:
        h.update(_pt(p))
    return h.hexdigest()


def dump_proof(path: str, proof: Proof, vk: VerifyingKey | None = None) -> None:
    """JSON envelope around the frozen bytes (reference proof.rs dump:
    proof + vk identity side by side)."""
    obj = {"format": MAGIC.decode(), "proof": proof_to_bytes(proof).hex()}
    if vk is not None:
        obj["vk_fingerprint"] = vk_fingerprint(vk)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def load_proof(path: str, vk: VerifyingKey | None = None) -> Proof:
    with open(path) as f:
        obj = json.load(f)
    if vk is not None and "vk_fingerprint" in obj:
        if obj["vk_fingerprint"] != vk_fingerprint(vk):
            raise ValueError("proof was generated under a different vk")
    return proof_from_bytes(bytes.fromhex(obj["proof"]))


def load_or_gen_proof(path: str, gen, vk: VerifyingKey | None = None) -> Proof:
    """Resume-from-artifact (reference common/prover/inner.rs:41): return
    the cached proof at `path` if present and vk-consistent, else call
    `gen()`, dump, and return."""
    if os.path.exists(path):
        try:
            return load_proof(path, vk)
        except (ValueError, KeyError, json.JSONDecodeError):
            pass  # stale/corrupt artifact: regenerate
    proof = gen()
    dump_proof(path, proof, vk)
    return proof
