"""The affine bases of the commit engines C and G and the plain forms of
their new stages, on the CPU: ``group.to_affine`` against the host golden
model, the plain mixed addition against the plain complete addition word
for word, and kernel C's sorted accumulation, fold and Horner
(``ec/msm.py``, the order kernel G's wide windows follow) against golden
bucket and window sums."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_tpu_torch.ec import goldens as g, group, msm as msmmod, pippenger as pip
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FQ

Q = FQ.modulus


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jacobian(pts, lams):
    """Affine int points (None = identity) -> (N, 3, 8) Jacobian with z = lam
    (x lam^2, y lam^3), lam = 1 the plain lift; the identity (1, 1, 0)."""
    rows = []
    for pt, lam in zip(pts, lams):
        if pt is None:
            rows += [FQ.r, FQ.r, 0]
        else:
            rows += [pt[0] * lam * lam % Q * FQ.r % Q, pt[1] * lam ** 3 % Q * FQ.r % Q, lam * FQ.r % Q]
    return ff.to_tensor(ff.words_from_ints(rows), "cpu").reshape(len(pts), 3, ff.W)


def _affine_words(pts):
    """Affine int points -> (N, 2, 8) Montgomery words, the identity (0, 0)."""
    rows = []
    for pt in pts:
        rows += [0, 0] if pt is None else [pt[0] * FQ.r % Q, pt[1] * FQ.r % Q]
    return ff.to_tensor(ff.words_from_ints(rows), "cpu").reshape(len(pts), 2, ff.W)


def _decode_affine(a):
    v = ff.ints_from_words(a)
    out = []
    for x, y in zip(v[0::2], v[1::2]):
        out.append(None if x == 0 and y == 0 else (x * pow(FQ.r, -1, Q) % Q, y * pow(FQ.r, -1, Q) % Q))
    return out


def test_to_affine_matches_goldens(rng):
    """Bases with z != 1 (as unsafe_setup makes them), z = 1 (as a loaded
    file holds them) and the identity, which becomes the sentinel (0, 0)."""
    pts = [g.random_point(rng) for _ in range(6)] + [None, g.G1_GEN]
    lams = [int(rng.integers(2, 1 << 62)) for _ in range(4)] + [1, 1, 5, 1]
    jac = _jacobian(pts, lams)
    got = group.to_affine(jac)
    assert got.shape == (8, 2, ff.W)
    assert _decode_affine(got) == pts == group.to_affine_ints(jac)
    assert torch.equal(got, group.PLAIN["to_affine"](jac))
    assert torch.equal(got, _affine_words(pts))
    # the unsafe SRS of the smoke's main paths, z != 1
    params_pts = group.from_affine_ints([g.scalar_mul(g.G1_GEN, k) for k in (1, 2, 3)], "cpu")
    doubled = group.double(params_pts)
    assert _decode_affine(group.to_affine(doubled)) == group.to_affine_ints(doubled)


@pytest.mark.parametrize("case", ["P+Q", "O+Q", "P+O", "O+O", "P+P", "P+-P", "-P+P", "zP+Q", "zP+P", "zP+-P"])
def test_madd_equals_add_on_z1(rng, case):
    """PLAIN["madd"] of Jacobian p and affine q gives, word for word, what
    PLAIN["add"] gives for q lifted to z = 1 (the identity base: (0, 0)
    against (1, 1, 0)); madd_sparse the same words."""
    p, q = g.random_point(rng), g.random_point(rng)
    lhs, rhs, lam = {
        "P+Q": (p, q, 1), "O+Q": (None, q, 1), "P+O": (p, None, 1), "O+O": (None, None, 1),
        "P+P": (p, p, 1), "P+-P": (p, g.neg(p), 1), "-P+P": (g.neg(p), p, 1),
        "zP+Q": (p, q, 7), "zP+P": (p, p, 11), "zP+-P": (p, g.neg(p), 13)}[case]
    jp = _jacobian([lhs], [lam])
    lifted = _jacobian([rhs], [1])
    aff = _affine_words([rhs])
    want = group.PLAIN["add"](jp, lifted)
    assert torch.equal(group.PLAIN["madd"](jp, aff), want)
    assert torch.equal(msmmod.madd_sparse(jp, aff), want)
    assert group.to_affine_ints(want) == [g.add(lhs, rhs)]


def _bucket_golden(pts, digits, nb):
    """Golden bucket sums: for each window, sum of +-P_i over |d_i| = b."""
    out = []
    for row in digits:
        buckets = [None] * nb
        for pt, d in zip(pts, row):
            if d:
                buckets[abs(d)] = g.add(buckets[abs(d)], g.neg(pt) if d < 0 else pt)
        out.append(buckets)
    return out


@pytest.mark.parametrize("kind", ["random", "one_run", "signed"])
def test_sorted_accumulation_and_fold_match_golden(rng, kind):
    """Kernel C's order of additions in plain PyTorch: the sorted
    accumulation over four levels (200 sorted points, chunks of 32, then of
    8; runs across chunk boundaries; one run over every chunk; negated
    bases), the fold in segments of 8 (with a ragged last one), then
    pairs, and Horner, against
    golden sums. Repeated and identity bases among the points."""
    n, nb, c = 200, 13, 4
    pts = [g.random_point(rng) for _ in range(n)]
    pts[3] = pts[4] = pts[5]  # repeated bases: the doubling case inside a run
    pts[7] = None  # the identity base
    if kind == "random":
        digits = rng.integers(0, nb, (2, n))
    elif kind == "one_run":
        digits = np.ones((2, n), dtype=np.int64)
        digits[1, :50] = 0
    else:
        digits = rng.integers(-(nb - 1), nb, (2, n))
        pts[9] = g.neg(pts[8])  # P and -P in one bucket
        digits[:, 8] = digits[:, 9] = 5
    digits = torch.from_numpy(digits)
    affine = _affine_words(pts)
    buckets = msmmod.plain_sorted_buckets(affine, digits, nb)
    gold = _bucket_golden(pts, digits.tolist(), nb)
    assert [group.to_affine_ints(buckets[w, 1:]) for w in range(2)] == [row[1:] for row in gold]
    wsums = msmmod.plain_fold(buckets)
    want = []
    for row in gold:
        acc = None
        for b in range(1, nb):
            acc = g.add(acc, g.scalar_mul(row[b], b) if row[b] is not None else None)
        want.append(acc)
    assert group.to_affine_ints(wsums) == want
    assert msmmod.fold_levels(nb) == [(2, 3), (1, 1)]
    total = group.to_affine_ints(msmmod.plain_horner(wsums, c)[None])[0]
    assert total == g.add(want[0], g.scalar_mul(want[1], 1 << c) if want[1] is not None else None)


def test_sort_digits_carries_signs():
    digits = torch.tensor([[3, -1, 0, -3, 1, 2]], dtype=torch.int32)
    sd, perm = msmmod.sort_digits(digits)
    assert sd.tolist() == [[0, 1, 1, 2, 3, 3]]
    assert perm.tolist() == [[2, ~1, 4, 5, 0, ~3]]


def test_engines_keep_affine_bases(rng):
    """G's engine converts its bases once (the CPU path too); C's keeps none
    on the CPU, where its plain version reads the Jacobian bases."""
    pts = [g.random_point(rng) for _ in range(16)]
    jac = _jacobian(pts, [int(rng.integers(2, 1000)) for _ in pts])
    engine = pip.PippengerMSM(jac)
    assert torch.equal(engine.affine, _affine_words(pts))
    assert msmmod.MSM(jac).affine is None
    sc = ff.to_tensor(ff.words_from_ints([int(rng.integers(0, 1 << 62)) for _ in pts]), "cpu")
    assert torch.equal(engine(sc), pip.msm(jac, sc))
    assert group.to_affine_ints(engine(sc)) == [g.msm(pts, [int(v) for v in ff.ints_from_words(sc)])]


# ---------------------------------------------------------------------------
# field.cuh's PTX field arithmetic (kernels A-I and M; curve.cuh's Ptx calls
# it), run on the CPU through a model of its opcodes for both moduli (the
# card is where it compiles; this holds the carry chains' text)
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[2] / "zkevm_tpu_torch" / "csrc"
FIELD_CUH = CSRC / "field.cuh"
M32 = (1 << 32) - 1


def _ptx_asm():
    """{function name: (PTX lines, operand expressions)} of field.cuh's
    functions that hold an asm statement, with ZK_MOD_OPERANDS(F) expanded."""
    src = FIELD_CUH.read_text()
    macro = re.search(r"#define ZK_MOD_OPERANDS\(F\)(.*?)\n\n", src, re.S).group(1).replace("\\", " ")
    out = {}
    for m in re.finditer(r"__device__ __forceinline__ [\w ]+? (\w+)\([^)]*\) \{(.*?)\n\}", src, re.S):
        asm = re.search(r"asm\((.*?)\);", m.group(2), re.S)
        if asm is None:
            continue
        parts = asm.group(1).replace("ZK_MOD_OPERANDS(F)", macro).split("\n    :")
        text = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', parts[0])).replace("\\n\\t", "\n")
        operands = [expr for sec in parts[1:] for expr in re.findall(r'"[=+]?[rn]"\(([^)]*)\)', sec)]
        out[m.group(1)] = ([ln.strip() for ln in text.splitlines() if ln.strip()], operands)
    return out


def _mod_constants(field: str) -> dict:
    """Mod<field>'s p0..p7 and ninv as field.cuh states them, keyed by the
    asm's operand expressions."""
    body = re.search(r"template <> struct Mod<%s> \{(.*?)\};" % field, FIELD_CUH.read_text(), re.S).group(1)
    return {f"Mod<F>::{name}": int(v, 16) for name, v in re.findall(r"(\w+) = (0x[0-9a-f]+)u", body)}


def _run_ptx(lines, operands, env):
    """Execute PTX lines over 32-bit registers with the carry flag; env maps
    operand expressions to values and gets the outputs back."""
    regs = {f"%{i}": env.get(e, 0) for i, e in enumerate(operands)}
    carry = [None]

    def val(tok):
        return int(tok, 0) if tok[0].isdigit() else regs[tok]

    for line in lines:
        if line in ("{", "}") or line.startswith(".reg"):
            continue
        op, rest = line.rstrip(";").split(None, 1)
        d, *src = [t.strip() for t in rest.split(",")]
        cin = 0
        if op.startswith(("madc", "addc", "subc")):
            assert carry[0] is not None, line
            cin = carry[0]
        if op.startswith(("mad", "madc")):
            x, y, z = (val(t) for t in src)
            s_ = ((x * y) & M32 if ".lo" in op else (x * y) >> 32) + z + cin
        elif op.startswith(("add", "addc")):
            s_ = val(src[0]) + val(src[1]) + cin
        elif op.startswith(("sub", "subc")):
            s_ = val(src[0]) - val(src[1]) - cin
        elif op == "mul.lo.u32":
            s_ = val(src[0]) * val(src[1])
        elif op == "mov.u32":
            s_ = val(src[0])
        elif op == "and.b32":
            s_ = val(src[0]) & val(src[1])
        elif op == "or.b32":
            s_ = val(src[0]) | val(src[1])
        elif op == "not.b32":
            s_ = ~val(src[0])
        else:
            raise AssertionError(f"opcode {op} not modelled")
        if ".cc" in op:
            carry[0] = (1 if s_ < 0 else 0) if op.startswith("sub") else s_ >> 32
        elif op.startswith(("madc", "addc", "subc")):
            carry[0] = None
            assert s_ <= M32 or not op.startswith("madc"), f"a product's carry lost: {line}"
        regs[d] = s_ & M32
    for i, e in enumerate(operands):
        env[e] = regs[f"%{i}"]
    return env


def _ptx_mul(asm, consts, a, b):
    t = [0] * 9
    for i in range(8):
        env = {f"t[{j}]": t[j] for j in range(9)} | {f"a.w[{j}]": a[j] for j in range(8)} | {"bi": b[i]}
        env = _run_ptx(*asm["fe_mont_row"], env)
        env = _run_ptx(*asm["fe_mont_redc"], env | consts)
        assert env["t[0]"] == 0
        t = [env[f"t[{j}]"] for j in range(1, 9)] + [0]
    env = _run_ptx(*asm["fe_mont_reduce"], {f"t[{j}]": t[j] for j in range(8)} | consts)
    return [env[f"r.w[{j}]"] for j in range(8)]


def _ptx_add(asm, consts, a, b):
    env = _run_ptx(*asm["fe_add"], {f"a.w[{j}]": a[j] for j in range(8)} | {f"b.w[{j}]": b[j] for j in range(8)})
    env = _run_ptx(*asm["fe_mont_reduce"], {f"t[{j}]": env[f"t[{j}]"] for j in range(8)} | consts)
    return [env[f"r.w[{j}]"] for j in range(8)]


def _ptx_sub(asm, consts, a, b):
    env = _run_ptx(*asm["fe_sub"], {f"a.w[{j}]": a[j] for j in range(8)} | {f"b.w[{j}]": b[j] for j in range(8)}
                   | consts)
    return [env[f"r.w[{j}]"] for j in range(8)]


def test_ptx_field_text_matches_integers(rng):
    """field.cuh's Montgomery product, addition and subtraction (one PTX
    text for both fields, the modulus as immediates from Mod<F>), for Fr
    and for Fq: edge values (0, 1, p - 1, R mod p, around p/2) and random
    ones against Python integers; Mod<F> holds each modulus and -p^-1 mod
    2^32."""
    asm = _ptx_asm()
    assert set(asm) == {"fe_mont_row", "fe_mont_redc", "fe_mont_reduce", "fe_add", "fe_sub"}
    assert sum(ln.startswith(("mad", "mul")) for ln in asm["fe_mont_row"][0] + asm["fe_mont_redc"][0]) == 33
    words = lambda x: [(x >> (32 * j)) & M32 for j in range(8)]  # noqa: E731
    value = lambda w: sum(v << (32 * j) for j, v in enumerate(w))  # noqa: E731
    for field, p in (("FR", ff.FR.modulus), ("FQ", Q)):
        consts = _mod_constants(field)
        assert value([consts[f"Mod<F>::p{j}"] for j in range(8)]) == p
        assert consts["Mod<F>::ninv"] == (-pow(p, -1, 1 << 32)) % (1 << 32)
        rinv = pow(1 << 256, -1, p)
        edge = [0, 1, 2, p - 1, p - 2, (1 << 256) % p, p // 2, p // 2 + 1]
        rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(40)]
        pairs = [(x, y) for x in edge for y in edge] + list(zip(rand, rand[::-1]))
        for x, y in pairs:
            assert value(_ptx_mul(asm, consts, words(x), words(y))) == x * y * rinv % p
            assert value(_ptx_add(asm, consts, words(x), words(y))) == (x + y) % p
            assert value(_ptx_sub(asm, consts, words(x), words(y))) == (x - y) % p


def test_curve_arithmetic_is_field_cuh():
    """curve.cuh holds no asm of its own: struct Ptx calls field.cuh's Fq
    product (as a function), addition and subtraction."""
    src = (CSRC / "curve.cuh").read_text()
    assert "asm(" not in src and "struct Cios" not in src
    ptx = src[src.index("struct Ptx {"):src.index("};", src.index("struct Ptx {"))]
    assert "fe_mul_call<FQ>" in ptx and "fe_add<FQ>" in ptx and "fe_sub<FQ>" in ptx
