"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/torch_kernels/`` at the repository root. The sources include no
PyTorch header and the libraries link against nothing of PyTorch: tensors
cross the boundary as data pointers and the stream as an integer, through
``ctypes``. The libraries are compiled in parallel, one ``nvcc``
process per source. A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and a stale library is never loaded.

Every C entry point launches one kernel on the stream it is given and
returns ``cudaGetLastError()``; :func:`launch` raises on a non-zero code and
adds one to the launch count of the kernel it names. The counts let a run
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
LIBRARIES = ("field", "ntt", "curve", "keccak", "poseidon", "pippenger", "kzg", "ntt4", "lazy13", "msm13", "quotient")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",  # registers, stack and spills of every kernel, kept in BUILD_LOGS
)

# Launch counts by kernel name; a name covers every C entry point of one
# kernel (for example the bit-reversal and the butterfly stages of "ntt").
KERNEL_NAMES = (
    "field_mul",
    "field_add_sub",
    "field_pow",
    "field_nonzero",
    "ntt",
    "ntt4",
    "g1_add",
    "g1_scalar_mul",
    "msm",
    "keccak",
    "poseidon",
    "pippenger",
    "kzg_open",
    "lazy13",
    "msm13",
    "quotient",
)
_counts = {name: 0 for name in KERNEL_NAMES}
BUILD_LOGS: dict[str, str] = {}  # nvcc's output for each library this process compiled
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def reset_launches() -> None:
    for name in _counts:
        _counts[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_counts)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every library that is not built yet, all in parallel.

    Returns the seconds each compile took (empty when all were built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in LIBRARIES if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    start = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    seconds, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            if not _lib_path(name).exists():
                build_all()
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def _function(lib: str, symbol: str, nargs: int):
    key = (lib, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(_library(lib), symbol)
        # every argument is passed as a 64-bit value: pointers, sizes and
        # the stream (ctypes would otherwise cut a pointer to 32 bits)
        fn.argtypes = [ctypes.c_void_p] * nargs
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def _raise_on(lib: str, symbol: str, err: int) -> None:
    if err != 0:
        msg = _function(lib, "zk_error_string", 1)
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"{symbol}: CUDA error {err}: {msg(err).decode()}")


def call(lib: str, symbol: str, *args) -> None:
    """Call a C entry point that launches no kernel (a copy of constants to
    the device, say) on the current stream; raises on its error code."""
    fn = _function(lib, symbol, len(args) + 1)
    _raise_on(lib, symbol, fn(*args, torch.cuda.current_stream().cuda_stream))


def launch(kernel: str, lib: str, symbol: str, *args) -> None:
    """Launch ``symbol`` of library ``lib`` on the current stream.

    ``args`` are data pointers and integers (each passed as 64 bits). The
    launch counts towards ``kernel``."""
    fn = _function(lib, symbol, len(args) + 1)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    _counts[kernel] += 1
    _raise_on(lib, symbol, err)


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, last: int | None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose
    last dimension is ``last`` (any size when ``last`` is None)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if last is not None and (t.dim() == 0 or t.shape[-1] != last):
        raise ValueError(f"{name}: expected last dimension {last}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
