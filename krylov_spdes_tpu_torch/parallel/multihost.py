"""Process-group initialization, the global mesh, and a one-host launcher.

Port of `krylov_spdes_tpu/parallel/multihost.py`, which replaces the
reference's SSH cluster bring-up (`add_my_procs`, Utils/PllUtils.jl:16-39:
hard-coded hostnames, tunneled addprocs) with `jax.distributed`. JAX is
single-controller on a host: one process drives all of its devices. Here
every rank is a process of its own (`torch.distributed`), so a host with
several ranks needs a launcher: `launch` spawns them, which is what one JAX
process over its local devices is to this multi-controller runtime.

The backend is explicit: NCCL for CUDA devices and gloo for the CPU unless
the caller names another. It never changes by itself. NCCL refuses two
ranks on one GPU, so several ranks sharing one card run gloo on
card-resident tensors, and say so.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from ..config import resolve
from .sharding import make_mesh

RENDEZVOUS_TIMEOUT = timedelta(seconds=60)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device=None,
                     timeout: timedelta = RENDEZVOUS_TIMEOUT) -> None:
    """Join the default process group (a no-op when it is already up).

    coordinator: an init method (`tcp://host:port`, `file:///path`) or
    `host:port`. With no coordinator and no process count, the environment
    of `torchrun` (`env://`) when it is set, else a world of one rank.
    backend: NCCL on a CUDA device and gloo otherwise, unless given. On a
    CUDA device the rank's current device becomes cuda:(process_id mod the
    device count), or the device's own index."""
    if dist.is_initialized():
        return
    device = resolve(device)[0]
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = dict(backend=backend, timeout=timeout)
    if coordinator is None and num_processes is None:
        if "WORLD_SIZE" in os.environ:
            kw["init_method"] = "env://"
        else:
            kw.update(store=dist.HashStore(), world_size=1, rank=0)
    else:
        kw.update(init_method=(coordinator if "://" in coordinator
                               else f"tcp://{coordinator}"),
                  world_size=num_processes, rank=process_id)
    if device.type == "cuda":
        rank = kw.get("rank", process_id)
        if rank is None:
            rank = int(os.environ.get("RANK", 0))
        torch.cuda.set_device(device.index if device.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(**kw)


def global_mesh(n_dom: int | None = None, n_chain: int = 1):
    """The (dom × chain) mesh over ALL ranks: 'dom' is the axis whose
    ranks exchange Γ sums every iteration (keep it within a host), 'chain'
    the embarrassingly parallel one."""
    return make_mesh(n_dom, n_chain)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(rank, fn, nprocs, inbox, backend, device, init_method, out):
    try:
        torch.set_num_threads(1)     # the ranks share the host's cores
        args = inbox.get()
        init_distributed(init_method, nprocs, rank, backend=backend,
                         device=device)
        out.put((rank, True, fn(*args)))
    except BaseException:            # reported to the parent, which fails
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, nprocs: int, args=(), backend: str | None = None, device=None,
           timeout: float = 300.0, init_method: str | None = None):
    """Run `fn(*args)` on nprocs ranks of one host, spawned (CUDA cannot
    fork), each in the default process group (`init_distributed`, whose
    rendezvous gives up after a minute). Returns the ranks' return values
    in rank order; they must pickle, and go through a queue. So do the
    arguments: a spawned process reads its start-up data only after it has
    imported the parent's main module, so arguments sent with the process
    would start the ranks one after the other.

    A rank that raises, dies, or a run past `timeout` seconds kills every
    rank and raises here. init_method: the rendezvous, by default a file in
    a fresh temporary directory."""
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="rendezvous-")
        init_method = f"file://{os.path.join(tmp, 'store')}"
    ctx = mp.get_context("spawn")
    inbox, out = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, nprocs, inbox, backend, device,
                               init_method, out), daemon=True)
             for r in range(nprocs)]
    results = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        for _ in procs:
            inbox.put(args)
        while len(results) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"launch: {nprocs - len(results)} of "
                                   f"{nprocs} ranks still running after "
                                   f"{timeout} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"launch: rank(s) {dead} died (exit codes "
                        f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        inbox.cancel_join_thread()    # a dead rank leaves its copy unread
        inbox.close()
        out.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(nprocs)]
