"""Phase timing and throughput metrics, and the reference's print helpers.

Port of `krylov_spdes_tpu/utils/metrics.py` (reference: Utils/PrintUtils.jl
:1-9, and SURVEY.md §5's phase timers, profiler traces and nnz/s metrics).
A phase's time includes the device work it launched: on a card the phase
ends in `torch.cuda.synchronize()`, where the JAX package calls
`jax.effects_barrier()`.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

from ..config import resolve


def printlnln(*args):
    """println + blank line after (PrintUtils.jl:1-4)."""
    print(*args)
    print()
    sys.stdout.flush()


def space_println(*args):
    """blank line before + println (PrintUtils.jl:6-9)."""
    print()
    print(*args)
    sys.stdout.flush()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseMetrics:
    """Named phase timings and derived throughputs; one-line JSON dump with
    the keys `t_<phase>` and `<phase>_nnz_per_s`. `device` is where the
    phases launch their work (the card by default)."""

    def __init__(self, device=None):
        self.device, _ = resolve(device)
        self.phases = {}
        self.counters = {}

    @contextlib.contextmanager
    def phase(self, name: str, nnz: int | None = None, verbose: bool = True):
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        dt = time.perf_counter() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt
        if nnz is not None:
            self.counters[f"{name}_nnz_per_s"] = nnz / dt
        if verbose:
            extra = f"  ({nnz / dt / 1e9:.2f} Gnnz/s)" if nnz else ""
            print(f"[{name}] {dt:.3f}s{extra}", flush=True)

    def add(self, name: str, value) -> None:
        self.counters[name] = value

    def json(self) -> str:
        return json.dumps({**{f"t_{k}": round(v, 4)
                              for k, v in self.phases.items()},
                           **{k: (round(v, 4) if isinstance(v, float) else v)
                              for k, v in self.counters.items()}})

    def dump(self) -> None:
        print(self.json(), flush=True)


@contextlib.contextmanager
def profiler_trace(logdir: str, device=None):
    """torch.profiler over the block (the card's kernels too when `device`
    is a card), written as a Chrome trace to `logdir`/trace.json."""
    device, _ = resolve(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync(device)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
