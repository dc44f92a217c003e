"""PyTorch port, the multi-rank layer (parallel/*, the dom-sharded DD plan,
the sharded two-level KL, entry.dryrun_multichip) against the JAX package's
shard_map layouts on conftest's 8-device virtual CPU mesh. float64.

The port's ranks are processes spawned by `parallel.launch` on the CPU over
gloo, with their rendezvous in a file under tmp_path (so that pytest-xdist
workers never share a port) and their own timeout: a rank that hangs,
raises or dies fails its test and kills the others. They run the helper
module tests/torch_rank_fns.py, which imports no JAX; the JAX side runs
here and its inputs reach the ranks as numpy arrays.

Tolerances: the port's sums over ranks run in another order than XLA's
psum over devices, so operators agree to rounding (rtol 1e-11 / atol
1e-12, tests/test_sharded.py's), the reduced KL matrix to 1e-10 / 1e-12
(tests/test_kl_device.py's) and KL eigenvalues to rtol 1e-9
(tests/test_sharded.py's). A CG count moves by one where a residual lands
on the tolerance. Integer tables are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from krylov_spdes_tpu import dd_chains as jdc
from krylov_spdes_tpu.fem.dd import assemble_dd_values
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.fem.partition import mesh_partition
from krylov_spdes_tpu.fem.schur import (get_schur_rhs, prepare_schur_operator,
                                        schur_matvec)
from krylov_spdes_tpu.kl import dd as jkl
from krylov_spdes_tpu.kl import dd_device as jdev
from krylov_spdes_tpu.kl.covariance import make_cov
from krylov_spdes_tpu.parallel.schur_sharded import (sharded_schur_matvec,
                                                     sharded_schur_rhs)
from krylov_spdes_tpu.parallel.sharding import make_mesh
from krylov_spdes_tpu.solvers.cg import cg

from krylov_spdes_tpu_torch import convert, entry
from krylov_spdes_tpu_torch import dd_chains as tdc
from krylov_spdes_tpu_torch.parallel import launch

import torch_rank_fns as ranks
from test_dd import build

torch.set_num_threads(1)
TIMEOUT = 240.0      # seconds a launch may take before its ranks are killed


def _launch(tmp_path, fn, n, *args):
    return launch(fn, n, args=args, backend="gloo", device="cpu",
                  timeout=TIMEOUT, init_method=f"file://{tmp_path}/rdv")


# --- (a), (b): the sharded Schur operator ----------------------------------

@pytest.fixture(scope="module")
def schur(tmp_path_factory):
    """tests/test_sharded.py's problem: JAX's sharded operator on 8
    devices, the port's on 4 ranks (4 of the 16 subdomains a rank)."""
    mesh, maps, epart, part, plan, asm, coeff = build(nnode=700, ndom=16,
                                                      seed=21)
    blocks = assemble_dd_values(plan, jnp.asarray(coeff))
    S = prepare_schur_operator(plan, part, *blocks[:3])
    b_I, b_G = blocks[3], blocks[4]
    x = np.random.default_rng(0).normal(size=S.n_gamma)
    dev_mesh = make_mesh(n_dom=8, n_chain=1)
    jax_side = dict(
        y=np.asarray(sharded_schur_matvec(dev_mesh, S)(jnp.asarray(x))),
        bs=np.asarray(sharded_schur_rhs(dev_mesh, S, b_I, b_G)),
        cg_it=int(cg(S, get_schur_rhs(S, b_I, b_G)).it),
        y_local=np.asarray(schur_matvec(S, jnp.asarray(x))))
    out = _launch(tmp_path_factory.mktemp("schur"), ranks.schur_rank, 4,
                  convert.numpy_fields(S), np.asarray(b_I), np.asarray(b_G),
                  x, 4)
    return jax_side, out


def test_sharded_schur_matvec_matches_jax(schur):
    """(a) sharded_schur_matvec on 4 ranks against JAX's on 8 devices (and
    JAX's unsharded apply); every rank holds the whole result."""
    j, out = schur
    assert [o["local_doms"] for o in out] == [4, 4, 4, 4]
    for o in out:
        np.testing.assert_allclose(o["y"], j["y"], rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(o["y"], j["y_local"], rtol=1e-11,
                                   atol=1e-12)
        np.testing.assert_array_equal(o["y"], out[0]["y"])


def test_sharded_schur_rhs_matches_jax(schur):
    """(a) sharded_schur_rhs of a global b_I against JAX's."""
    j, out = schur
    for o in out:
        np.testing.assert_allclose(o["bs"], j["bs"], rtol=1e-11, atol=1e-12)


def test_sharded_cg_solve(schur):
    """(a) CG through the sharded operator: `it` within 1 of the unsharded
    CG's (JAX's), the same count and bits on every rank."""
    j, out = schur
    assert abs(out[0]["cg_it"] - j["cg_it"]) <= 1
    for o in out:
        assert o["cg_it"] == out[0]["cg_it"]
        np.testing.assert_array_equal(o["cg_x"], out[0]["cg_x"])


def test_example08_nn_pcg_on_sharded_operator(schur):
    """(b) Example 08: pcg(S, b_s, M=NN(S)) on shard_schur_operator's S
    runs unchanged; the same `it` as the unsharded solve and x within
    1e-10."""
    _, out = schur
    for o in out:
        assert o["ex08_it"] == o["ex08_it_ref"]
        # 1e-10 absolute and relative to the largest entry, the stricter
        scale = min(1.0, np.abs(o["ex08_x_ref"]).max())
        np.testing.assert_allclose(o["ex08_x"], o["ex08_x_ref"], rtol=0,
                                   atol=1e-10 * scale)


# --- (c): init_distributed / global_mesh / is_coordinator -------------------

def test_two_process_init_and_global_mesh(tmp_path):
    """(c) the twin of tests/test_multihost.py: two processes join one
    group through a file rendezvous, rank 0 alone is the coordinator, the
    global (dom=2 × chain=1) mesh spans both, and psum / all_gather_cat
    return the same rank-ordered result on each."""
    coord = f"file://{tmp_path}/rdv"
    out = launch(ranks.init_rank, 2, args=(coord,), backend="gloo",
                 device="cpu", timeout=TIMEOUT, init_method=coord)
    assert [o["rank"] for o in out] == [0, 1]
    assert [o["coordinator"] for o in out] == [True, False]
    for o in out:
        assert o["world"] == 2 and o["shape"] == {"dom": 2, "chain": 1}
        assert o["chain"] == 0 and o["dom"] == o["rank"]
        np.testing.assert_array_equal(o["psum"], [10.0, 12.0, 14.0])
        np.testing.assert_array_equal(o["gathered"],
                                      [[0.0, 1.0, 2.0], [10.0, 11.0, 12.0]])
        assert o["psum_calls"] == 1 and o["psum_bytes"] == 2 * 3 * 8


def test_launch_reports_a_failed_rank(tmp_path):
    """A rank that raises fails the launch with its traceback, and the
    other rank, blocked in a collective, is killed."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch(ranks.failing_rank, 2, backend="gloo", device="cpu",
               timeout=TIMEOUT, init_method=f"file://{tmp_path}/rdv")


# --- (d): the dom-sharded DD plan and _local_condense -----------------------

@pytest.fixture(scope="module")
def dd_problem():
    """tests/test_dd_chains.py's problem (420 nodes, 8 subdomains)."""
    mesh, maps, epart, part, plan, asm, coeff = build(nnode=420, ndom=8,
                                                      seed=3)
    return part, plan, coeff


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_dd_assembly_plan_tables_match_jax(dd_problem, n_shards):
    """(d) shard_dd_assembly_plan's integer tables equal the JAX
    package's, and its value tables to rounding, for every shard count
    that divides the 8 subdomains."""
    part_j, plan_j, _ = dd_problem
    sj = jdc.shard_dd_assembly_plan(plan_j, part_j, n_shards)
    plan_t = convert.dd_assembly_plan(**convert.numpy_fields(plan_j),
                                      device="cpu", dtype=torch.float64)
    part_t = convert.dd_partition(**convert.numpy_fields(part_j))
    st = tdc.shard_dd_assembly_plan(plan_t, part_t, n_shards)
    via = convert.sharded_dd_plan(**convert.numpy_fields(sj), device="cpu",
                                  dtype=torch.float64)
    for f in dataclasses.fields(tdc.ShardedDDPlan):
        a, b, c = (getattr(x, f.name) for x in (st, sj, via))
        if isinstance(a, int):
            assert a == b == c, f.name
        elif a.dtype == torch.int64:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)
            np.testing.assert_array_equal(c.numpy(), np.asarray(b),
                                          err_msg=f.name)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15,
                                       atol=0, err_msg=f.name)
            np.testing.assert_array_equal(c.numpy(), np.asarray(b),
                                          err_msg=f.name)


def _jax_local_condense(sj, coeff, x, n_shards):
    """JAX's _local_condense inside shard_map on n_shards virtual
    devices: (A x, M x, b_schur), as make_dom_sharded_dd_chain_step
    squeezes and specs the plan."""
    mesh = Mesh(np.asarray(jax.devices()[:n_shards]), ("dom",))
    leaves = {f.name for f in dataclasses.fields(sj)
              if not isinstance(getattr(sj, f.name), int)}
    whole = {"cells", "bG_fixed", "gamma_cnt"}
    pspec = dataclasses.replace(sj, **{k: P() if k in whole else P("dom")
                                       for k in leaves})

    def local(sp, coeff, x):
        sp = dataclasses.replace(sp, **{k: getattr(sp, k)[0]
                                        for k in leaves - whole})
        A, M, b_s = jdc._local_condense(sp, coeff, "dom")
        return A(x), M(x), b_s

    f = shard_map(local, mesh=mesh, in_specs=(pspec, P(), P()),
                  out_specs=(P(), P(), P()), check_vma=False)
    return [np.asarray(a) for a in jax.jit(f)(sj, jnp.asarray(coeff),
                                              jnp.asarray(x))]


def test_local_condense_matches_jax(dd_problem, tmp_path):
    """(d) on 2 ranks: each shard's _local_condense (refill, condensation,
    assembled and NN applies with the psum) on a fixed coefficient against
    JAX's inside shard_map, at 1e-10."""
    part_j, plan_j, coeff = dd_problem
    n_shards = 2
    sj = jdc.shard_dd_assembly_plan(plan_j, part_j, n_shards)
    x = np.random.default_rng(1).normal(size=part_j.n_gamma)
    Ax, Mx, b_s = _jax_local_condense(sj, coeff, x, n_shards)
    out = _launch(tmp_path, ranks.condense_rank, n_shards,
                  convert.numpy_fields(sj), coeff, x, n_shards)
    for o in out:
        for key, ref in (("Ax", Ax), ("Mx", Mx), ("b_s", b_s)):
            # 1e-10 absolute and relative to the largest entry, the stricter
            scale = min(1.0, np.abs(ref).max())
            np.testing.assert_allclose(o[key], ref, rtol=0, atol=1e-10 * scale,
                                       err_msg=key)


# --- (g): the sharded two-level KL ------------------------------------------

def test_sharded_kl_matches_jax(tmp_path):
    """(g) on 3 ranks (8 and 12 subdomains split unevenly):
    compute_dd_kl(device_mesh=) against JAX's on 8 devices
    (tests/test_sharded.py's problem), λ rtol 1e-9;
    reduced_covariance_device(mesh=) from JAX's ρ against JAX's sharded K
    (tests/test_kl_device.py's problem), 1e-10 / 1e-12; and
    compute_dd_kl_device(mesh=) against JAX's unsharded λ, rtol 1e-9 with
    the trailing λ (down to 1e-11) held to their float64 accuracy,
    1e-14·max λ, as tests/test_torch_kl_dd.py holds them."""
    mesh = get_mesh(500, seed=3)
    ndom = 8
    epart, _ = mesh_partition(mesh.cells, mesh.points, ndom,
                              mesh.cell_neighbors)
    lam_j, _ = jkl.compute_dd_kl(
        mesh.cells, mesh.points, epart, ndom, make_cov("sexp", 1.0, 0.4),
        nev=15, device_mesh=Mesh(np.asarray(jax.devices()), ("dom",)))

    mesh2 = get_mesh(600, jitter=0.2, seed=4)
    ndom2, L2 = 12, 0.3
    epart2, _ = mesh_partition(mesh2.cells, mesh2.points, ndom2,
                               mesh2.cell_neighbors)
    cov2 = make_cov("sexp", sig2=1.0, L=L2)
    tables = jdev.build_kl_tables(mesh2.cells, mesh2.points, epart2, ndom2)
    _, _, rho, _, _ = jdev.local_kls_device(tables, mesh2.points, cov2, 10,
                                            dom_chunk=4)
    K_j = np.asarray(jdev.reduced_covariance_device(
        tables, mesh2.points, rho, cov2, pair_chunk=4,
        mesh=make_mesh(n_dom=8, n_chain=1)))
    lam_dev_j, _ = jdev.compute_dd_kl_device(
        mesh2.cells, mesh2.points, epart2, ndom2, cov2, nev=10,
        dom_chunk=4, pair_chunk=4)

    out = _launch(tmp_path, ranks.kl_rank, 3, mesh.cells, mesh.points, epart,
                  ndom, 15, 0.4,
                  (mesh2.cells, mesh2.points, epart2, ndom2, L2),
                  np.asarray(rho), 4, 3)
    for o in out:
        k = min(len(o["lam"]), len(lam_j))
        np.testing.assert_allclose(o["lam"][:k], lam_j[:k], rtol=1e-9)
        np.testing.assert_allclose(o["K"], K_j, rtol=1e-10, atol=1e-12)
        k = min(len(o["lam_dev"]), len(lam_dev_j))
        np.testing.assert_allclose(o["lam_dev"][:k], lam_dev_j[:k],
                                   rtol=1e-9, atol=1e-14 * lam_dev_j.max())
        np.testing.assert_array_equal(o["K"], out[0]["K"])


# --- (h): the multi-rank dry run ----------------------------------------------

def test_dryrun_multichip_on_cpu_ranks():
    """(h) entry.dryrun_multichip on 4 CPU ranks over gloo (dom 2 ×
    chain 2, 8 subdomains, 4 chains): its asserts hold on every rank and
    rank 0's line comes back."""
    line = entry.dryrun_multichip(4, backend="gloo", device="cpu")
    assert line.startswith("dryrun_multichip OK: 4 devices, mesh "
                           "(dom=2, chain=2), ndom=8, nchains=4")
