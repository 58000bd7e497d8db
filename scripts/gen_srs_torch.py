"""Write test SRS files in the halo2 layout with the PyTorch port.

Usage: python scripts/gen_srs_torch.py [--device cuda|cpu] [--out DIR] [k ...]   (default: 14)

The port's counterpart of ``scripts/gen_srs.py``: ``unsafe_setup(k,
tau=777)`` and ``write_params_file`` into ``DIR/params<k>`` (default
``build/srs`` in the repository), on the card by default or on the CPU when
asked. The file loads with ``zkevm_tpu_torch.kzg.srs.load_params_file`` and
with the reference's loader alike. An existing file is left as it is.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from zkevm_tpu_torch.kzg.params import ParamsKZG  # noqa: E402
from zkevm_tpu_torch.kzg.srs import params_path, write_params_file  # noqa: E402

TAU = 777


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ks", nargs="*", type=int, default=[14])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(ROOT / "build" / "srs"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for k in args.ks:
        path = params_path(args.out, k)
        if os.path.exists(path):
            print(f"[gen_srs_torch] {path} exists", flush=True)
            continue
        t0 = time.perf_counter()
        params = ParamsKZG.unsafe_setup(k, tau=TAU, device=args.device)
        t1 = time.perf_counter()
        write_params_file(params, path, tau=TAU)
        print(f"[gen_srs_torch] k={k} on {args.device}: setup={t1 - t0:.1f}s "
              f"write={time.perf_counter() - t1:.1f}s -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
