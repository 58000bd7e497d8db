"""Row-layout constants and xor gadgets of the keccak-f circuit, the part
of ``zkevm_tpu/circuits/keccak_circuit.py`` that the KeccakTable circuit
(``keccak_table.py``) builds on.

One permutation costs 25 + 24 * 75 = 1825 rows: an input state block of
25 rows, then per round a 75-row block (C rows, theta output rows, chi
output rows).
"""

from __future__ import annotations

from zkevm_tpu_torch.plonk.expr import Const, Expr

ROUNDS = 24
BLOCK = 75
INPUT_ROWS = 25
TOTAL_ROWS = INPUT_ROWS + ROUNDS * BLOCK  # 1825


def _xor2(a: Expr, b: Expr) -> Expr:
    return a + b - Const(2) * a * b


def _xor5(vs) -> Expr:
    acc = vs[0]
    for v in vs[1:]:
        acc = _xor2(acc, v)
    return acc  # degree 5 multilinear parity
