"""The counts behind chip_smoke.py's QB_ENVELOPE: its quantized_bank phase in
float64 on the CPU at a small size.

    python3 krylov_spdes_tpu_torch/bench/bank_envelope.py [nnode]

Runs `chip_smoke.run_quantized_bank` (Examples 20, 19, 14 and 13) on
get_mesh(nnode) (default 4000) with build_kl's KL model (SExp, σ² 1, L
0.1, nev 50, relative 0.995) solved densely, every tensor float64 on the
CPU, and the envelope opened so that nothing is held; prints the phase's
JSON line. chip_smoke holds the card's float32 counts at 32k to half the
least and twice the largest count printed here (the preconditioned counts
of a Cholesky or AMG of a nearby field depend little on the mesh size).
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from krylov_spdes_tpu_torch import config  # noqa: E402

config.config.device, config.config.dtype = "cpu", torch.float64

import chip_smoke as cs  # noqa: E402
from krylov_spdes_tpu_torch import fem, kl  # noqa: E402
from krylov_spdes_tpu_torch.utils import PhaseMetrics  # noqa: E402


def main(nnode: int = 4000) -> None:
    cs.QB_ENVELOPE = {k: ((0, float("inf")) if isinstance(v, tuple)
                          else float("inf"))
                      for k, v in cs.QB_ENVELOPE.items()}
    mesh = fem.get_mesh(nnode)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    M = fem.get_mass_matrix(mesh.cells, mesh.points)
    lam, psi = kl.solve_kl(mesh.cells, mesh.points,
                           kl.make_cov(cs.KL_MODEL, cs.KL_SIG2, cs.KL_L),
                           cs.KL_NEV, M, relative=cs.KL_RELATIVE,
                           method="dense")
    cs.run_quantized_bank("cpu, float64", PhaseMetrics(), mesh, maps, lam,
                          psi, dev="cpu")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
