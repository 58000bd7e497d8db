"""The recorded reference proofs (``tests/vectors/torch_port_toy_proof.json``,
which the port's tests and ``chip_smoke.py`` compare against) still equal
what ``scripts/record_torch_vectors.py`` produces from the JAX package."""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_vector_file_is_current():
    spec = importlib.util.spec_from_file_location(
        "record_torch_vectors", ROOT / "scripts" / "record_torch_vectors.py")
    rec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rec)
    assert json.loads(rec.OUT.read_text()) == rec.record()
