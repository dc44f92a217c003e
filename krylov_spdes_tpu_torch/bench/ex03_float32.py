"""The float32 size of Example 03's two cross-checks, behind chip_smoke.py's
EX03_BOUNDS: the driver in float32 on the CPU at its default size.

    python3 krylov_spdes_tpu_torch/bench/ex03_float32.py [nnode] [ndom]

Runs `examples/ex03_dd_schur.main` (default get_mesh(4000) in 20
subdomains, the drivers' default width) with every tensor float32 on the
CPU in place of the card, and prints one JSON line with the archive's
`apply_err` (matrix-free against assembled Schur apply, the largest
absolute difference) and `sol_err` (DD against monolithic solution) and
the float64 run's for scale. chip_smoke holds the card's float32 values to
ten times the float32 ones printed here (the card sums in other orders).
"""

import contextlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from krylov_spdes_tpu_torch.examples import ex03_dd_schur  # noqa: E402
from krylov_spdes_tpu_torch.examples import common  # noqa: E402


def run(nnode: int, ndom: int, dtype) -> dict:
    def backend(args):
        args.device, args.dtype = torch.device("cpu"), dtype
        return args.device, args.dtype

    with tempfile.TemporaryDirectory() as d:
        ex03_dd_schur.init_backend = backend
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                ex03_dd_schur.main(["--nnode", str(nnode), "--ndom", str(ndom),
                                    "--cpu", "--data-dir", d])
            (path,) = Path(d).glob("*.ex03.npz")
            a = np.load(path)
            return {k: float(a[k]) for k in ("apply_err", "sol_err")} | {
                "iters": a["iters"].tolist()}
        finally:
            ex03_dd_schur.init_backend = common.init_backend


def main(nnode: int = 4000, ndom: int = 20) -> None:
    torch.set_num_threads(4)
    print(json.dumps({"nnode": nnode, "ndom": ndom,
                      "float32": run(nnode, ndom, torch.float32),
                      "float64": run(nnode, ndom, torch.float64)}))


if __name__ == "__main__":
    main(*map(int, sys.argv[1:]))
