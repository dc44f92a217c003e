"""PyTorch port, the stencil solve slice end to end against the JAX package:
mesh → stencil assembly plan → seeded lognormal realizations → dense refill
→ padded refill → whole-solve Jacobi PCG → certified refined PCG (float64,
CPU, plain kernel versions). Also: the port imports no jax, and its entry
points run on the card unless told otherwise."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

from krylov_spdes_tpu.fem import stencil_assembly as jsa
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.ops import fused_cg as jfc
from krylov_spdes_tpu.solvers.refine import refined_pcg as j_refined_pcg

import krylov_spdes_tpu_torch.fem as tfem
from krylov_spdes_tpu_torch.ops import fused_cg as tfc
from krylov_spdes_tpu_torch.solvers.refine import refined_pcg

torch.set_num_threads(1)


def f_src(x, y):
    return -1.0 + 0.0 * x


def u_zero(x, y):
    return 0.0 * x


def test_slice_matches_jax_per_realization():
    mesh = get_mesh(1600)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    plan_j = jsa.prepare_stencil_assembly(mesh, maps, f_src, u_zero)
    mesh_t = tfem.get_mesh(1600)
    maps_t = tfem.get_dirichlet_inds(mesh_t.points, mesh_t.point_markers)
    plan_t = tfem.prepare_stencil_assembly(mesh_t, maps_t, f_src, u_zero,
                                           device="cpu", dtype=torch.float64)
    ps_j = ps_t = None
    for seed in range(3):
        coeff = np.exp(0.3 * np.random.default_rng(seed).normal(
            size=mesh.nnode))
        Sj, bj = jsa.make_stencil_operator(plan_j, jnp.asarray(coeff))
        St, bt = tfem.make_stencil_operator(plan_t, coeff)
        bnorm = float(np.linalg.norm(np.asarray(bj)))
        # the padded operator is built once and refilled per realization
        ps_j = (jfc.build_padded_stencil(Sj, tb=16) if ps_j is None
                else jfc.refill_padded_stencil(ps_j, Sj))
        ps_t = (tfc.build_padded_stencil(St) if ps_t is None
                else tfc.refill_padded_stencil(ps_t, St))
        assert ps_t.K == ps_j.K == 5

        xj, itj, resj = jfc.vmem_pcg(ps_j, bj, maxit=1500, interpret=True)
        xt, itt, rest = tfc.vmem_pcg(ps_t, bt, maxit=1500)
        assert abs(int(itt) - int(itj)) <= 2          # 5-plane form
        assert float(rest) <= 1e-7 * bnorm
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                                   atol=1e-9)

        dj = 1.0 / Sj.diagonal()
        dt = 1.0 / St.diagonal()
        rj = j_refined_pcg(Sj, bj, M=Partial(lambda d, r: d * r, dj))
        rt = refined_pcg(St, bt, M=lambda r: dt * r)
        assert float(rt.res_norm[0]) <= 1e-7 * bnorm and not rt.failed
        assert rt.refines == rj.refines
        xr = np.asarray(rj.x)
        np.testing.assert_allclose(rt.x.numpy(), xr, rtol=1e-8,
                                   atol=1e-8 * np.abs(xr).max())


def test_port_imports_no_jax():
    code = ("import sys, krylov_spdes_tpu_torch, krylov_spdes_tpu_torch.convert;"
            "import krylov_spdes_tpu_torch.solvers.refine;"
            "import krylov_spdes_tpu_torch.ops.fused_cg;"
            "import krylov_spdes_tpu_torch.ops.pallas_cg;"
            "import krylov_spdes_tpu_torch.fem.partition;"
            "import krylov_spdes_tpu_torch.fem.native;"
            "import krylov_spdes_tpu_torch.fem.dd;"
            "import krylov_spdes_tpu_torch.fem.schur;"
            "import krylov_spdes_tpu_torch.fem.dd_stencil;"
            "import krylov_spdes_tpu_torch.dd_chains;"
            "import krylov_spdes_tpu_torch.entry;"
            "assert 'jax' not in sys.modules, 'jax';"
            "bad = [m for m in sys.modules if m.startswith('krylov_spdes_tpu.')"
            " or m == 'krylov_spdes_tpu'];"
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_every_module_imports_with_jax_blocked():
    """Every module of the port, the measurement scripts under bench/ and
    the drivers under examples/ included, imports in a process where
    `import jax` fails, runs nothing on import, and none of them loads the
    JAX package."""
    code = (
        "import sys, pkgutil, importlib;"
        "sys.modules['jax'] = None;"
        "import krylov_spdes_tpu_torch as p;"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')];"
        "[importlib.import_module(n) for n in names];"
        "bad = [m for m in sys.modules if m == 'krylov_spdes_tpu'"
        " or m.startswith('krylov_spdes_tpu.')];"
        "assert not bad, bad;"
        "bench = {n.rsplit('.', 1)[1] for n in names if '.bench.' in n};"
        "want = {'bench_amg', 'bench_banded', 'bench_chain', "
        "'bench_dd_chain', 'bench_vmem_eigdef', 'bench_vmem_stretch', "
        "'stretch_phases', 'collectives'};"
        "assert want <= bench, want - bench;"
        "assert len(names) > 100, names;"
        "print(len(names))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_point_without_device_does_not_run_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks a host without a CUDA device")
    mesh = tfem.get_mesh(100)
    maps = tfem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    with pytest.raises((RuntimeError, AssertionError)):
        tfem.prepare_stencil_assembly(mesh, maps, f_src, u_zero)
    with pytest.raises((RuntimeError, AssertionError)):
        tfem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f_src,
                                       u_zero)
