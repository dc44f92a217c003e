"""Contiguous mesh partitioning (host-side, NumPy): the METIS replacement.

The port's own copy of `krylov_spdes_tpu/fem/partition.py`. The reference
shells out to the `mpmetis` C binary for a contiguous `ndom`-way element
partition (Fem/Mesh.jl:169-293). Here: recursive coordinate (inertial)
bisection over element centroids with balanced counts, followed by a
contiguity repair pass that reassigns stray connected components to the
neighbouring part they touch most. Balanced parts keep the padding waste
low when the subdomains are batched on the device.

Two partitioners give two different partitions, and so two different Schur
systems: the C++ one (`fem/native.py`, the repo's `native/partition.cpp`:
RCB + FM boundary refinement + contiguity, a lower edge cut) and the NumPy
one of this module. `mesh_partition(use_native=True)` is the C++ partition
and raises when its library cannot be built; it never gives the NumPy
partition in its place. `use_native=False` is the NumPy partition.

Outputs match the reference convention:
- ``epart`` (nel,)   part id of each element, in [0, ndom)
- ``npart`` (nnode,) a host part for each node (used only to bucket strictly
  interior nodes, cf. Fem/EllipticPdeDomainDecomposition.jl:170-175)
"""

from __future__ import annotations

import os

import numpy as np


def _inertial_split(idx: np.ndarray, centroids: np.ndarray, n_left: int):
    """Split element set `idx` into (left, right) with |left| = n_left along the
    principal axis of its centroid cloud."""
    c = centroids[idx]
    c0 = c - c.mean(axis=0)
    # Principal direction of the 2x2 covariance (closed form, no LAPACK needed).
    cov = c0.T @ c0
    w, v = np.linalg.eigh(cov)
    axis = v[:, -1]
    proj = c0 @ axis
    order = np.argsort(proj, kind="stable")
    return idx[order[:n_left]], idx[order[n_left:]]


def _rcb(idx: np.ndarray, centroids: np.ndarray, nparts: int, out: np.ndarray,
         first_part: int) -> None:
    if nparts == 1:
        out[idx] = first_part
        return
    n_left_parts = nparts // 2
    n_left = int(round(len(idx) * n_left_parts / nparts))
    left, right = _inertial_split(idx, centroids, n_left)
    _rcb(left, centroids, n_left_parts, out, first_part)
    _rcb(right, centroids, nparts - n_left_parts, out, first_part + n_left_parts)


def _repair_contiguity(epart: np.ndarray, cell_neighbors: np.ndarray,
                       ndom: int) -> np.ndarray:
    """Reassign all but the largest connected component of each part to the
    neighboring part with the most shared edges (mirrors METIS `-contig`)."""
    nel = epart.shape[0]
    epart = epart.copy()
    for _ in range(10):  # usually converges in 1-2 passes
        changed = False
        comp = -np.ones(nel, dtype=np.int64)
        comp_sizes = []
        comp_part = []
        nc = 0
        for e0 in range(nel):
            if comp[e0] >= 0:
                continue
            # BFS within same part
            stack = [e0]
            comp[e0] = nc
            size = 0
            while stack:
                e = stack.pop()
                size += 1
                for j in range(3):
                    ne = cell_neighbors[e, j]
                    if ne >= 0 and comp[ne] < 0 and epart[ne] == epart[e]:
                        comp[ne] = nc
                        stack.append(ne)
            comp_sizes.append(size)
            comp_part.append(epart[e0])
            nc += 1
        comp_sizes = np.asarray(comp_sizes)
        comp_part = np.asarray(comp_part)
        # Largest component per part keeps its label.
        keep = np.zeros(nc, dtype=bool)
        for d in range(ndom):
            comps_d = np.nonzero(comp_part == d)[0]
            if len(comps_d):
                keep[comps_d[np.argmax(comp_sizes[comps_d])]] = True
        stray = ~keep[comp]
        if not stray.any():
            break
        # Reassign each stray component to the adjacent foreign part touched most.
        for ci in np.nonzero(~keep)[0]:
            elems = np.nonzero(comp == ci)[0]
            votes = {}
            for e in elems:
                for j in range(3):
                    ne = cell_neighbors[e, j]
                    if ne >= 0 and comp[ne] != ci:
                        votes[epart[ne]] = votes.get(epart[ne], 0) + 1
            if votes:
                epart[elems] = max(votes.items(), key=lambda kv: kv[1])[0]
                changed = True
        if not changed:
            break
    return epart


def mesh_partition(cells: np.ndarray, points: np.ndarray, ndom: int,
                   cell_neighbors: np.ndarray | None = None,
                   use_native: bool = True):
    """Contiguous ndom-way element partition + node part assignment.

    Counterpart of the reference's `mesh_partition` (Fem/Mesh.jl:169-225).
    Returns (epart, npart), both 0-based. use_native=True (with
    cell_neighbors and ndom > 1) is the C++ partitioner's partition and
    raises if its library cannot be built; use_native=False is the NumPy
    partition (see the module docstring: the two differ).
    """
    nel = cells.shape[0]
    nnode = int(cells.max()) + 1
    centroids = points[cells].mean(axis=1)

    if use_native and cell_neighbors is not None and ndom > 1:
        from .native import native_partition
        epart, _ = native_partition(cell_neighbors, centroids, ndom)
    else:
        epart = np.empty(nel, dtype=np.int32)
        _rcb(np.arange(nel), centroids, ndom, epart, 0)
        if cell_neighbors is not None and ndom > 1:
            epart = _repair_contiguity(epart, cell_neighbors, ndom)

    # npart: assign each node the part of the first element containing it
    # (METIS-like: any owning part; only consumed for strictly-interior nodes).
    npart = -np.ones(nnode, dtype=np.int32)
    flat = cells.ravel()
    eids = np.repeat(np.arange(nel), 3)
    # reversed so the lowest element index wins
    npart[flat[::-1]] = epart[eids[::-1]]
    return epart, npart


def save_partition(epart, npart, tentative_nnode: int, ndom: int,
                   data_dir: str = "data") -> None:
    os.makedirs(data_dir, exist_ok=True)
    np.savez(os.path.join(data_dir, f"DoF{tentative_nnode}-ndom{ndom}.part.npz"),
             epart=epart, npart=npart)


def load_partition(tentative_nnode: int, ndom: int, data_dir: str = "data"):
    d = np.load(os.path.join(data_dir, f"DoF{tentative_nnode}-ndom{ndom}.part.npz"))
    return d["epart"], d["npart"]
