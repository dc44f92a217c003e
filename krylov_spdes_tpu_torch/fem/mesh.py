"""Triangular meshes of the unit square (host-side, NumPy).

The port's own copy of `krylov_spdes_tpu/fem/mesh.py` (importing that module
would import jax through the JAX package's `__init__`): the structured
`get_mesh`, the Delaunay `get_delaunay_mesh`, `element_geometry`,
`get_total_area` and the NPZ persistence, whose files either package loads.
Arrays have the reference's meaning (Fem/Mesh.jl):

- ``cells``          (nel, 3)   int32   node indices of each triangle (0-based)
- ``points``         (nnode, 2) float64 node coordinates
- ``point_markers``  (nnode,)   int32   1 = Dirichlet boundary node, 0 = interior
- ``cell_neighbors`` (nel, 3)   int32   neighbor across edge opposite local
                                        vertex k, or -1 on the boundary
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class TriMesh:
    cells: np.ndarray          # (nel, 3) int32
    points: np.ndarray         # (nnode, 2) float64
    point_markers: np.ndarray  # (nnode,) int32
    cell_neighbors: np.ndarray  # (nel, 3) int32

    @property
    def nel(self) -> int:
        return self.cells.shape[0]

    @property
    def nnode(self) -> int:
        return self.points.shape[0]


def _cell_neighbors(cells: np.ndarray) -> np.ndarray:
    """Neighbor element across the edge opposite each local vertex (-1 if
    none). Interior edges appear exactly twice among the sorted edge keys."""
    nel = cells.shape[0]
    nnode = int(cells.max()) + 1
    # edge opposite local vertex k is (v_{k+1}, v_{k+2})
    a = cells[:, [1, 2, 0]].ravel().astype(np.int64)
    b = cells[:, [2, 0, 1]].ravel().astype(np.int64)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = lo * nnode + hi
    owner_e = np.repeat(np.arange(nel, dtype=np.int64), 3)
    owner_k = np.tile(np.arange(3, dtype=np.int64), nel)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    dup = ks[:-1] == ks[1:]                     # matched pairs
    i1 = order[:-1][dup]
    i2 = order[1:][dup]
    neighbors = -np.ones((nel, 3), dtype=np.int32)
    neighbors[owner_e[i1], owner_k[i1]] = owner_e[i2]
    neighbors[owner_e[i2], owner_k[i2]] = owner_e[i1]
    return neighbors


def get_mesh(tentative_nnode: int, jitter: float = 0.0, seed: int = 0) -> TriMesh:
    """Triangulation of the unit square with ~tentative_nnode nodes
    (Fem/Mesh.jl:21-29: the node count is approximate). `jitter` in [0, 0.5)
    perturbs interior nodes by that fraction of the grid spacing."""
    if tentative_nnode < 1:
        raise ValueError(f"tentative_nnode must be >= 1, got {tentative_nnode}")
    m = max(1, int(round(np.sqrt(tentative_nnode) - 1)))
    n1 = m + 1
    xs = np.linspace(0.0, 1.0, n1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    points = np.stack([X.ravel(), Y.ravel()], axis=1).astype(np.float64)

    if jitter > 0.0:
        rng = np.random.default_rng(seed)
        h = 1.0 / m
        interior = (
            (points[:, 0] > 0) & (points[:, 0] < 1)
            & (points[:, 1] > 0) & (points[:, 1] < 1)
        )
        delta = rng.uniform(-jitter * h, jitter * h, size=(points.shape[0], 2))
        points[interior] += delta[interior]

    # cell (i, j) -> elements 2*(i*m+j), 2*(i*m+j)+1 with the union-jack
    # alternating diagonal (avoids mesh anisotropy)
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    p00 = (ii * n1 + jj).astype(np.int32)
    p10 = p00 + 1
    p01 = p00 + n1
    p11 = p01 + 1
    even = ((ii + jj) % 2 == 0)
    t0 = np.where(even[:, None],
                  np.stack([p00, p10, p11], 1), np.stack([p00, p10, p01], 1))
    t1 = np.where(even[:, None],
                  np.stack([p00, p11, p01], 1), np.stack([p10, p11, p01], 1))
    cells = np.empty((2 * m * m, 3), dtype=np.int32)
    cells[0::2] = t0
    cells[1::2] = t1

    markers = (
        (points[:, 0] <= 0.0) | (points[:, 0] >= 1.0)
        | (points[:, 1] <= 0.0) | (points[:, 1] >= 1.0)
    )
    # Boundary coordinates are exact (jitter only moved interior nodes).
    on_bnd = (
        (np.abs(points[:, 0]) < 1e-14) | (np.abs(points[:, 0] - 1) < 1e-14)
        | (np.abs(points[:, 1]) < 1e-14) | (np.abs(points[:, 1] - 1) < 1e-14)
    )
    point_markers = (markers | on_bnd).astype(np.int32)

    return TriMesh(cells, points, point_markers, _cell_neighbors(cells))


def get_delaunay_mesh(tentative_nnode: int, seed: int = 0) -> TriMesh:
    """Unstructured triangulation: Delaunay (scipy) over uniform interior
    points from numpy's `default_rng(seed)` and regular boundary points, the
    Triangle replacement of the reference's `get_mesh` (Fem/Mesh.jl:21-29).
    The same (tentative_nnode, seed) gives the JAX package's mesh cell for
    cell."""
    rng = np.random.default_rng(seed)
    nb = max(4, int(np.sqrt(tentative_nnode)))
    t = np.linspace(0.0, 1.0, nb)
    boundary = np.concatenate([
        np.stack([t, np.zeros(nb)], 1), np.stack([t, np.ones(nb)], 1),
        np.stack([np.zeros(nb), t], 1), np.stack([np.ones(nb), t], 1)])
    boundary = np.unique(boundary, axis=0)
    n_int = max(1, tentative_nnode - boundary.shape[0])
    interior = rng.uniform(0.02, 0.98, size=(n_int, 2))
    points = np.concatenate([boundary, interior]).astype(np.float64)

    from scipy.spatial import Delaunay
    cells = Delaunay(points).simplices.astype(np.int32)
    # counter-clockwise orientation (positive areas)
    p = points[cells]
    area2 = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
             - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    flip = area2 < 0
    cells[flip, 1], cells[flip, 2] = cells[flip, 2].copy(), \
        cells[flip, 1].copy()

    on_bnd = ((np.abs(points[:, 0]) < 1e-12)
              | (np.abs(points[:, 0] - 1) < 1e-12)
              | (np.abs(points[:, 1]) < 1e-12)
              | (np.abs(points[:, 1] - 1) < 1e-12))
    return TriMesh(cells, points, on_bnd.astype(np.int32),
                   _cell_neighbors(cells))


def get_total_area(cells: np.ndarray, points: np.ndarray) -> float:
    """Total mesh area by the shoelace formula (Fem/Mesh.jl:110-144)."""
    p = points[cells]  # (nel, 3, 2)
    x, y = p[..., 0], p[..., 1]
    area = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
            - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])) / 2.0
    return float(area.sum())


def element_geometry(cells: np.ndarray, points: np.ndarray):
    """Per-element shoelace terms and areas (Fem/EllipticPde.jl:91-99).

    Returns (dx, dy, area) with dx, dy of shape (nel, 3) and area (nel,).
    dx[:, k] = x_{k+2} - x_{k+1}, dy[:, k] = y_{k+1} - y_{k+2} (indices mod 3),
    which makes grad(phi_k) = (dy_k, dx_k) / (2 area).
    """
    p = points[cells]  # (nel, 3, 2)
    x, y = p[..., 0], p[..., 1]
    dx = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], axis=1)
    dy = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], axis=1)
    area = (dx[:, 2] * dy[:, 1] - dx[:, 1] * dy[:, 2]) / 2.0
    return dx, dy, area


# NPZ persistence (the artifact convention of Fem/Mesh.jl:52-91, 0-based):
# the JAX package's file names and fields, so either package loads the other's.

def save_mesh(mesh: TriMesh, tentative_nnode: int, data_dir: str = "data") -> None:
    os.makedirs(data_dir, exist_ok=True)
    base = os.path.join(data_dir, f"DoF{tentative_nnode}")
    np.savez(base + ".mesh.npz",
             cells=mesh.cells, points=mesh.points,
             point_markers=mesh.point_markers,
             cell_neighbors=mesh.cell_neighbors)


def load_mesh(tentative_nnode: int, data_dir: str = "data") -> TriMesh:
    base = os.path.join(data_dir, f"DoF{tentative_nnode}")
    d = np.load(base + ".mesh.npz")
    return TriMesh(d["cells"], d["points"], d["point_markers"],
                   d["cell_neighbors"])
