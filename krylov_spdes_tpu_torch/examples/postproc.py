"""Postprocessing plots for the example drivers' NPZ outputs.

Port of `examples/postproc.py`, which replaces the reference's matplotlib
layer (postproc_utils.py:1-79 and the Example*.py scripts):
iteration mean±std curves per method (Example09...py:36-75), field and
partition rendering with tripcolor (postproc_utils.py:20-72). The mesh and
the partition come from the port; either package's archives read alike.
matplotlib is imported by the plotting functions alone.

Usage:
  python -m krylov_spdes_tpu_torch.examples.postproc iters \\
      data/<root>.ex09.iters.npz out.png
  python -m krylov_spdes_tpu_torch.examples.postproc field \\
      data/<root>.ex02.kl.npz out.png
  python -m krylov_spdes_tpu_torch.examples.postproc partition <nnode> \\
      <ndom> out.png
"""

from __future__ import annotations

import sys

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_iters(npz_path: str, out: str):
    """Mean±std per-sample iteration curves across chains per method. The
    archive's 0-d entries (ex09's nchains, nvec, ...) are settings, not
    curves, and are skipped."""
    plt = _pyplot()
    d = np.load(npz_path)
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name in d.files:
        arr = d[name]
        if arr.ndim == 0 or arr.dtype.kind not in "iu" or name == "status":
            continue
        if arr.ndim == 1:
            arr = arr[None, :]
        mean = arr.mean(axis=0)
        std = arr.std(axis=0)
        s = np.arange(1, mean.shape[0] + 1)
        ax.plot(s, mean, label=name, marker="o", ms=3)
        ax.fill_between(s, mean - std, mean + std, alpha=0.2)
    ax.set_xlabel("sample s along chain")
    ax.set_ylabel("solver iterations")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=130)
    plt.close(fig)
    print(f"wrote {out}")


def plot_field(npz_path: str, out: str):
    """tripcolor of a nodal field (g or u) on the mesh."""
    from ..fem import get_mesh
    plt = _pyplot()
    d = np.load(npz_path)
    key = "g" if "g" in d.files else ("u" if "u" in d.files else d.files[0])
    field = d[key]
    mesh = get_mesh(field.shape[0])
    fig, ax = plt.subplots(figsize=(5.5, 5))
    tpc = ax.tripcolor(mesh.points[:, 0], mesh.points[:, 1],
                       mesh.cells, field, shading="gouraud")
    fig.colorbar(tpc, ax=ax)
    ax.set_aspect("equal")
    ax.set_title(key)
    fig.tight_layout()
    fig.savefig(out, dpi=130)
    plt.close(fig)
    print(f"wrote {out}")


def plot_partition(nnode: int, ndom: int, out: str):
    from ..fem import get_mesh, mesh_partition
    plt = _pyplot()
    mesh = get_mesh(nnode)
    epart, _ = mesh_partition(mesh.cells, mesh.points, ndom,
                              mesh.cell_neighbors)
    fig, ax = plt.subplots(figsize=(5.5, 5))
    ax.tripcolor(mesh.points[:, 0], mesh.points[:, 1], mesh.cells,
                 facecolors=epart.astype(float), cmap="tab20")
    ax.set_aspect("equal")
    ax.set_title(f"{ndom}-way partition")
    fig.tight_layout()
    fig.savefig(out, dpi=130)
    plt.close(fig)
    print(f"wrote {out}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    cmd = argv[0] if argv else None
    if cmd == "iters":
        plot_iters(argv[1], argv[2])
    elif cmd == "field":
        plot_field(argv[1], argv[2])
    elif cmd == "partition":
        plot_partition(int(argv[1]), int(argv[2]), argv[3])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
