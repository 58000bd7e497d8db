"""PLONKish runtime on torch: ConstraintSystem, expressions, assignment,
MockProver, keygen, prover (lookups, permutation, quotient, SHPLONK) and
verifier."""

from zkevm_tpu_torch.plonk.assign import Assignment
from zkevm_tpu_torch.plonk.cs import Column, ConstraintSystem
from zkevm_tpu_torch.plonk.expr import Const, DomainX, Expr, Query
from zkevm_tpu_torch.plonk.keygen import ProvingKey, VerifyingKey, keygen
from zkevm_tpu_torch.plonk.mock import Failure, MockProver
from zkevm_tpu_torch.plonk.prover import Proof, create_proof
from zkevm_tpu_torch.plonk.verifier import verify_proof

__all__ = [
    "Assignment",
    "Column",
    "ConstraintSystem",
    "Const",
    "DomainX",
    "Expr",
    "Query",
    "ProvingKey",
    "VerifyingKey",
    "keygen",
    "Failure",
    "MockProver",
    "Proof",
    "create_proof",
    "verify_proof",
]
