"""Time the port's collectives on one card: `psum` (an all-gather summed in
rank order) of a Γ-sized vector, and `all_gather_cat` of a chain's
deflation basis, over NCCL at one rank and over gloo at 2 and 4 ranks that
share the card (NCCL takes one rank a GPU).

    python3 krylov_spdes_tpu_torch/bench/collectives.py

Prints one JSON line per (backend, ranks) with µs a call (host clock
around 200 calls, synchronised), the bytes each rank receives, and the
card's name and power limit. Run on the card, from the root of the
checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

N_GAMMA = 1637             # dd_general's interface (32k nodes, 30 subdomains)
W_SHAPE = (250000, 16)     # a chain's basis on the 250k grid, nvec 16
REPS = 200


def _time(fn, reps):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def _rank():
    import torch.distributed as dist
    from krylov_spdes_tpu_torch.parallel import (all_gather_cat, make_mesh,
                                                 psum)
    mesh = make_mesh(dist.get_world_size(), 1)
    x = torch.randn(N_GAMMA, device="cuda")
    W = torch.randn(W_SHAPE, device="cuda")[None]
    n = mesh.size
    return dict(backend=dist.get_backend(), ranks=n,
                us_psum_gamma=_time(lambda: psum(x, mesh, "dom"), REPS),
                psum_bytes_received=n * x.numel() * 4,
                us_all_gather_basis=_time(
                    lambda: all_gather_cat(W, mesh, "dom"), 10),
                basis_bytes_received=n * W.numel() * 4)


def main() -> int:
    from krylov_spdes_tpu_torch.parallel import launch
    if not torch.cuda.is_available():
        print("collectives: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for backend, n in (("nccl", 1), ("gloo", 2), ("gloo", 4)):
        out = launch(_rank, n, backend=backend, device="cuda", timeout=300)
        print(json.dumps({**out[0], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
