"""Dirichlet boundary-condition index maps (host-side, NumPy).

The port's own copy of `krylov_spdes_tpu/fem/bc.py`: dense int32 index
arrays in place of the reference's Dict-based g2l/l2g maps
(Fem/BoundaryConditions.jl:35-185).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DirichletMaps:
    """free_g2l[g]  = local free-dof index of global node g, or -1 if Dirichlet
    dir_g2l[g]   = local Dirichlet index of global node g, or -1 if free
    free_l2g     = global node index of each free dof
    dir_l2g      = global node index of each Dirichlet node
    is_dirichlet = boolean mask over global nodes
    """
    free_g2l: np.ndarray
    dir_g2l: np.ndarray
    free_l2g: np.ndarray
    dir_l2g: np.ndarray
    is_dirichlet: np.ndarray

    @property
    def n_free(self) -> int:
        return self.free_l2g.shape[0]

    @property
    def n_dirichlet(self) -> int:
        return self.dir_l2g.shape[0]


def get_dirichlet_inds(points: np.ndarray, point_markers: np.ndarray) -> DirichletMaps:
    """Separate Dirichlet (marker==1) from free nodes
    (Fem/BoundaryConditions.jl:35-63); local indices follow ascending global
    node order, like the reference's insertion order."""
    is_dir = np.asarray(point_markers).ravel() == 1
    nnode = is_dir.shape[0]
    free_l2g = np.nonzero(~is_dir)[0].astype(np.int32)
    dir_l2g = np.nonzero(is_dir)[0].astype(np.int32)
    free_g2l = -np.ones(nnode, dtype=np.int32)
    dir_g2l = -np.ones(nnode, dtype=np.int32)
    free_g2l[free_l2g] = np.arange(free_l2g.shape[0], dtype=np.int32)
    dir_g2l[dir_l2g] = np.arange(dir_l2g.shape[0], dtype=np.int32)
    return DirichletMaps(free_g2l, dir_g2l, free_l2g, dir_l2g, is_dir)


def apply_dirichlet(segments: np.ndarray, points: np.ndarray, A, b_vec,
                    uexact):
    """Legacy row/column elimination of Dirichlet nodes on a FULL-size system
    (reference `apply_dirichlet`, Fem/BoundaryConditions.jl:138-185): zero
    the node's row and column, move the column into the RHS, put 1 on the
    diagonal. Host-side: A is a scipy sparse matrix (or anything scipy
    takes) over ALL nodes, b_vec a vector (a tensor is copied to the host);
    returns the modified copies (scipy CSR, numpy)."""
    import scipy.sparse as sp
    A = sp.lil_matrix(A)
    if hasattr(b_vec, "detach"):
        b_vec = b_vec.detach().cpu().numpy()
    b = np.asarray(b_vec, dtype=float).copy()
    nodes = np.unique(np.asarray(segments)[:, 0])
    for nod in nodes:
        g = uexact(points[nod, 0], points[nod, 1])
        col = A[:, nod].toarray().ravel()
        b -= col * g
        A[nod, :] = 0
        A[:, nod] = 0
        A[nod, nod] = 1.0
        b[nod] = g
    return sp.csr_matrix(A), b


def append_bc(maps: DirichletMaps, u_free, points: np.ndarray, uexact):
    """Re-insert Dirichlet values into the full nodal solution vector
    (Fem/BoundaryConditions.jl:94-134). `u_free` may be a tensor."""
    if hasattr(u_free, "detach"):
        u_free = u_free.detach().cpu().numpy()
    u_free = np.asarray(u_free)
    u = np.empty(maps.free_g2l.shape[0], dtype=u_free.dtype)
    u[maps.free_l2g] = u_free
    xd = points[maps.dir_l2g]
    u[maps.dir_l2g] = uexact(xd[:, 0], xd[:, 1])
    return u
