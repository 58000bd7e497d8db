"""The port never imports JAX or the reference package: every ``.py`` under
``zkevm_tpu_torch/``, ``chip_smoke.py`` and the mesh tests' rank module
``tests/port/_mesh_worker.py`` (the spawned ranks must not import JAX),
parsed with ``ast``. Every CUDA source under ``zkevm_tpu_torch/csrc`` is a
library that ``kernels.py`` builds, with a plain C interface (no PyTorch
header)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FILES = sorted((ROOT / "zkevm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                            ROOT / "tests" / "port" / "_mesh_worker.py"]
BANNED = ("jax", "jaxlib", "zkevm_tpu")


def _imported(tree: ast.AST) -> list[str]:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in BANNED


def test_port_files_found():
    assert len(FILES) > 40 and (ROOT / "zkevm_tpu_torch" / "hash" / "poseidon.py") in FILES
    assert (ROOT / "zkevm_tpu_torch" / "parallel" / "mesh.py") in FILES
    assert (ROOT / "zkevm_tpu_torch" / "ff" / "lazy13.py") in FILES
    assert (ROOT / "zkevm_tpu_torch" / "ec" / "msm13.py") in FILES


CSRC = sorted((ROOT / "zkevm_tpu_torch" / "csrc").glob("*.cu*"))


def test_cuda_sources_are_built_libraries():
    from zkevm_tpu_torch import kernels

    assert sorted(p.stem for p in CSRC if p.suffix == ".cu") == sorted(kernels.LIBRARIES)
    assert {"lazy13", "msm13"} <= set(kernels.LIBRARIES) and {"lazy13", "msm13"} <= set(kernels.KERNEL_NAMES)


@pytest.mark.parametrize("path", CSRC, ids=lambda p: p.name)
def test_cuda_source_includes_no_torch_header(path):
    includes = [ln for ln in path.read_text().splitlines() if ln.startswith("#include")]
    assert includes and not [ln for ln in includes if "torch" in ln or "ATen" in ln or "c10" in ln], includes


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imported(ast.parse(path.read_text(), str(path))) if _banned(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_catches_imports():
    src = "import jax.numpy\nfrom zkevm_tpu.ff import FR\nimport zkevm_tpu_torch\n__import__('jaxlib')\n"
    assert [n for n in _imported(ast.parse(src)) if _banned(n)] == ["jax.numpy", "zkevm_tpu.ff", "jaxlib"]
