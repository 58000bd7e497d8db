"""The PLONKish verifier: verify_proof.

Port of ``zkevm_tpu/plonk/verifier.py`` (host code; the transcript hashes
on the params' device). Analog of halo2_proofs plonk::verify_proof (scroll-tech/halo2 v1.1;
reference call sites: prover/src/evm.rs:39 EVM verify, MockProver-vs-real
checks). Host-side by design — a verifier touches a few dozen group
elements; the production verifier is an L1 contract (reference emits YUL,
prover/src/evm.rs:13) or the in-circuit recursion verifier.

Mirrors the prover's transcript schedule exactly, recomputes every
challenge, evaluates the shared protocol constraint trees at x over the
claimed evals (plonk.expr.host_evaluate), derives the expected
quotient eval, and runs the SHPLONK pairing check.
"""

from __future__ import annotations

from zkevm_tpu_torch.ff.goldens import FQ_MOD, FR_MOD
from zkevm_tpu_torch.kzg.params import ParamsKZG
from zkevm_tpu_torch.plonk import shplonk
from zkevm_tpu_torch.plonk.cs import ConstraintSystem
from zkevm_tpu_torch.plonk.expr import HostEvalContext, host_evaluate
from zkevm_tpu_torch.plonk.keygen import VerifyingKey
from zkevm_tpu_torch.plonk.protocol import build_protocol
from zkevm_tpu_torch.plonk.prover import Proof
from zkevm_tpu_torch.transcript import KeccakTranscript, PoseidonTranscript


def _lagrange_evals_at(x: int, rows, n: int, omega: int) -> dict[int, int]:
    """l_row(x) for the requested row indices: w^row (x^n - 1)/(n (x - w^row))."""
    xn1 = (pow(x, n, FR_MOD) - 1) % FR_MOD
    n_inv = pow(n, FR_MOD - 2, FR_MOD)
    out = {}
    for r in rows:
        wr = pow(omega, r % n, FR_MOD)
        out[r] = xn1 * n_inv % FR_MOD * wr % FR_MOD * pow(
            (x - wr) % FR_MOD, FR_MOD - 2, FR_MOD
        ) % FR_MOD
    return out


def _instance_eval(values: list[int], x: int, n: int, omega: int) -> int:
    """Evaluate the interpolation of `values` (rows 0..len-1, rest 0) at x."""
    lag = _lagrange_evals_at(x, range(len(values)), n, omega)
    acc = 0
    for i, v in enumerate(values):
        acc = (acc + v * lag[i]) % FR_MOD
    return acc


def _g1_valid(pt) -> bool:
    """Affine BN254 G1 membership: identity (None) or y^2 == x^3 + 3.
    Cofactor is 1, so the curve check is full subgroup membership —
    standard deserialization hazard guard (halo2curves `from_bytes`)."""
    if pt is None:
        return True
    if not (isinstance(pt, tuple) and len(pt) == 2):
        return False
    x, y = pt
    if not (0 <= x < FQ_MOD and 0 <= y < FQ_MOD):
        return False
    return (y * y - (x * x * x + 3)) % FQ_MOD == 0


def _proof_shape_ok(cs: ConstraintSystem, proof: Proof) -> bool:
    """Validate every proof list length + every group element before any
    transcript absorption (malformed proofs must return False, not crash,
    and off-curve points must never reach the EC/pairing math)."""
    num_pieces_max = 64  # h pieces are bounded by extended-domain factor
    if len(proof.advice_commitments) != len(cs.advice_columns):
        return False
    if len(proof.lookup_permuted) != len(cs.lookups):
        return False
    if any(len(p) != 2 for p in proof.lookup_permuted):
        return False
    chunk = cs.permutation_chunk_len()
    nperm = len(cs.permutation_columns)
    num_chunks = (nperm + chunk - 1) // chunk if nperm else 0
    if len(proof.perm_z_commitments) != num_chunks:
        return False
    if len(proof.lookup_z_commitments) != len(cs.lookups):
        return False
    if not (1 <= len(proof.h_commitments) <= num_pieces_max):
        return False
    pts = list(proof.advice_commitments)
    for ca, cb in proof.lookup_permuted:
        pts += [ca, cb]
    pts += proof.perm_z_commitments
    pts += proof.lookup_z_commitments
    pts.append(proof.random_commitment)
    pts += proof.h_commitments
    pts += [proof.shplonk_h, proof.shplonk_w]
    return all(_g1_valid(p) for p in pts)


def verify_proof(
    params: ParamsKZG,
    vk: VerifyingKey,
    instances: list[list[int]],
    proof: Proof,
    *,
    transcript: KeccakTranscript | PoseidonTranscript | None = None,
) -> bool:
    cs = vk.cs
    domain = vk.domain
    k, n = domain.k, domain.n
    usable = cs.usable_rows(n)
    u_row = usable - 1
    omega = domain.omega
    tr = transcript or KeccakTranscript(params.device)

    if not _proof_shape_ok(cs, proof):
        return False

    # -- transcript replay ------------------------------------------------
    tr.common_scalar(k)
    for inst in instances:
        for v in inst:
            tr.common_scalar(v)
    for c in vk.fixed_commitments + vk.sigma_commitments:
        tr.common_point(c)

    challenge_vals: dict[int, int] = {}
    for phase in range(cs.num_phases):
        for col in cs.advice_columns:
            if col.phase != phase:
                continue
            # index by column, mirroring the prover's advice_comm[c]
            # absorption — robust to interleaved phase declarations
            tr.common_point(proof.advice_commitments[cs.advice_columns.index(col)])
        for ch in cs.challenges:
            if ch.phase == phase + 1:
                challenge_vals[ch.index] = tr.challenge()
    challenges_int = [challenge_vals.get(i, 0) for i in range(len(cs.challenges))]

    theta = tr.challenge()
    for ca, cb in proof.lookup_permuted:
        tr.common_point(ca)
        tr.common_point(cb)
    beta = tr.challenge()
    gamma = tr.challenge()
    for c in proof.perm_z_commitments:
        tr.common_point(c)
    for c in proof.lookup_z_commitments:
        tr.common_point(c)
    tr.common_point(proof.random_commitment)
    y = tr.challenge()
    for c in proof.h_commitments:
        tr.common_point(c)
    x = tr.challenge()

    protocol = build_protocol(cs, n, theta, beta, gamma)
    expected_n_evals = len(protocol.queries) + 1
    if len(proof.evals) != expected_n_evals:
        return False
    for v in proof.evals:
        tr.common_scalar(v)

    evals_map = dict(zip(protocol.queries, proof.evals[:-1]))
    random_eval = proof.evals[-1]

    # -- expected quotient eval ------------------------------------------
    # instance evals (verifier-computed) + virtual lagrange columns
    full_evals = dict(evals_map)
    inst_queries = set()
    for con, _w in protocol.constraints:
        for col, rot in con.queries():
            if col.kind == "instance":
                inst_queries.add((col, rot))
    inst_by_col = {c: inst for c, inst in zip(cs.instance_columns, instances)}
    for col, rot in inst_queries:
        pt = pow(omega, rot % n, FR_MOD) * x % FR_MOD
        full_evals[(col, rot)] = _instance_eval(inst_by_col[col], pt, n, omega)
    l0c, llastc, lblindc = protocol.virtual_cols
    lag = _lagrange_evals_at(x, [0, u_row] + list(range(usable, n)), n, omega)
    full_evals[(l0c, 0)] = lag[0]
    full_evals[(llastc, 0)] = lag[u_row]
    full_evals[(lblindc, 0)] = sum(lag[r] for r in range(usable, n)) % FR_MOD

    ctx = HostEvalContext(full_evals, challenges_int, x)
    acc = 0
    for con, width in protocol.constraints:
        if width:
            for lane in range(width):
                ctx.lane = lane
                acc = (acc * y + host_evaluate(con, ctx)) % FR_MOD
            ctx.lane = 0
        else:
            acc = (acc * y + host_evaluate(con, ctx)) % FR_MOD
    xn = pow(x, n, FR_MOD)
    zh_x = (xn - 1) % FR_MOD
    expected_h = acc * pow(zh_x, FR_MOD - 2, FR_MOD) % FR_MOD

    # -- assemble shplonk queries (must mirror prover order) -------------
    fixed_comm = {c: vk.fixed_commitments[i] for i, c in enumerate(cs.fixed_columns)}
    advice_comm = {
        c: proof.advice_commitments[i] for i, c in enumerate(cs.advice_columns)
    }

    def commitment_of(col):
        if col.kind == "fixed":
            return fixed_comm[col]
        if col.kind == "advice":
            return advice_comm[col]
        if col.kind == "aux":
            name = str(col.index)
            if name.startswith("sigma"):
                return vk.sigma_commitments[int(name[5:])]
            if name.startswith("lookup_a_perm"):
                return proof.lookup_permuted[int(name[13:])][0]
            if name.startswith("lookup_s_perm"):
                return proof.lookup_permuted[int(name[13:])][1]
            if name.startswith("lookup_z"):
                return proof.lookup_z_commitments[int(name[8:])]
            if name.startswith("perm_z"):
                return proof.perm_z_commitments[int(name[6:])]
        raise KeyError(col)

    queries = []
    for (col, rot) in protocol.queries:
        pt = pow(omega, rot % n, FR_MOD) * x % FR_MOD
        queries.append(
            (f"{col.kind}:{col.index}", commitment_of(col), pt, evals_map[(col, rot)])
        )
    queries.append(("random", proof.random_commitment, x, random_eval))
    # collapsed h commitment: sum x^{n i} C_i as a combo handle
    combo = []
    w = 1
    for c in proof.h_commitments:
        combo.append((w, c))
        w = w * xn % FR_MOD
    queries.append(("h_collapsed", combo, x, expected_h))

    return shplonk.verify_many_with_proof(
        params, queries, proof.shplonk_h, proof.shplonk_w, tr
    )
