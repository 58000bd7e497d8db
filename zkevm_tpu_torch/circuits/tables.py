"""Shared lookup-table fabric + challenge/RLC idiom (the part of
zkevm_tpu/circuits/tables.py the KeccakTable circuit needs).

Reference counterparts:
- `Challenges { evm_word, keccak_input, lookup_input }`
  (zkevm-circuits/src/util.rs:55-66): three after-phase-0 challenges that
  every subcircuit shares; word values and variable-length byte streams
  are bound as random linear combinations (RLC) under them.
- `table.rs` (zkevm-circuits/src/table.rs:208-3322): each shared table
  (KeccakTable, BytecodeTable, ...) is a set of columns one circuit FILLS
  and other circuits LOOK UP — the composition mechanism of the zkEVM.

TPU-native difference: a table here is a set of *expressions* (columns at
rotations, selector-gated), not dedicated columns — the owning circuit's
own working columns serve as the table surface directly, so exposing a
table costs zero extra commitments. Consumers register ordinary lookups
against the exprs. Disabled rows compress to the all-zero tuple, which
only matches consumers' disabled (all-zero) input tuples.

RLC conventions (shared by producers and consumers):
- byte-stream RLC (keccak_input): acc = 0; for each byte in stream order:
  acc = acc * r + byte.
- word/hash RLC (evm_word): same fold over the 32 digest bytes in digest
  order (digest[0] first).
"""

from __future__ import annotations

from dataclasses import dataclass

from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.plonk.cs import Challenge, ConstraintSystem
from zkevm_tpu_torch.plonk.expr import Expr


@dataclass
class Challenges:
    """The shared challenge set (util.rs:55). All three are usable after
    phase 0: phase-0 advice carries raw bytes/bits, phase-1 advice carries
    the RLC accumulators."""

    evm_word: Challenge
    keccak_input: Challenge
    lookup_input: Challenge

    @classmethod
    def configure(cls, cs: ConstraintSystem) -> "Challenges":
        return cls(
            cs.challenge_usable_after(0),
            cs.challenge_usable_after(0),
            cs.challenge_usable_after(0),
        )


def rlc_bytes(data: bytes, r: int) -> int:
    """Host-side golden for the byte-stream RLC convention above."""
    acc = 0
    for b in data:
        acc = (acc * r + b) % FR_MOD
    return acc


@dataclass
class KeccakTable:
    """One row per FINAL sponge permutation (table.rs:1435 KeccakTable:
    is_enabled, input_rlc, input_len, output). Filled by the keccak table
    circuit; consumed by bytecode/tx/... circuits. The digest is exposed
    both as RLC(evm_word) and as (lo, hi) 128-bit halves — the halves are
    free expressions over the digest bit rows (no extra columns) and let
    phase-0 consumers (RwTable word-lo-hi fabric, EVM circuit code_hash)
    link hashes without touching phase-1."""

    enabled: Expr
    input_rlc: Expr  # RLC(keccak_input) over the unpadded message bytes
    input_len: Expr
    output_rlc: Expr  # RLC(evm_word) over the 32 digest bytes
    output_lo: Expr  # low 128 bits of the big-endian digest integer
    output_hi: Expr

    def lookup(self, cs: ConstraintSystem, name: str, q: Expr,
               input_rlc: Expr, input_len: Expr, output_rlc: Expr) -> None:
        """Register `keccak(stream with rlc/len) == digest with output_rlc`
        gated by q (q must be 0/1; all inputs are multiplied by it)."""
        cs.lookup(
            name,
            [
                (q, self.enabled),
                (q * input_rlc, self.input_rlc),
                (q * input_len, self.input_len),
                (q * output_rlc, self.output_rlc),
            ],
        )

    def lookup_word(self, cs: ConstraintSystem, name: str, q: Expr,
                    input_rlc: Expr, input_len: Expr,
                    output_lo: Expr, output_hi: Expr) -> None:
        """Like lookup, but against the digest's (lo, hi) word halves."""
        cs.lookup(
            name,
            [
                (q, self.enabled),
                (q * input_rlc, self.input_rlc),
                (q * input_len, self.input_len),
                (q * output_lo, self.output_lo),
                (q * output_hi, self.output_hi),
            ],
        )
