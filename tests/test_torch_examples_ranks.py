"""PyTorch port, the multi-rank drivers (examples/ex05_kl_dd_distributed.py,
ex08_dd_parallel.py, ex17_recyclers_mcmc.py --fast --layout sharded,
scaling_harness.py) on gloo ranks on the CPU in float64.

The JAX drivers run as tests/test_examples_smoke.py runs them: a
subprocess with --cpu on 8 virtual devices
(`--xla_force_host_platform_device_count=8`). The port's run in this
process through `main(argv)` with --cpu and --ranks, its ranks spawned by
`parallel.launch` (each with a timeout, `common.RANK_TIMEOUT`)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_example_cases as tc


@pytest.fixture(autouse=True)
def rank_timeout(monkeypatch):
    """Every multi-rank run here ends within 240 s or fails."""
    from krylov_spdes_tpu_torch.examples import common
    monkeypatch.setattr(common, "RANK_TIMEOUT", 240.0)
    return monkeypatch


def run_jax_devices(module, args, workdir, ndev=8):
    """The JAX driver on ndev virtual CPU devices; its archives."""
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = tc.EXDIR + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + \
        f" --xla_force_host_platform_device_count={ndev}"
    r = subprocess.run(
        [sys.executable, os.path.join(tc.EXDIR, module + ".py"), "--cpu"]
        + list(args) + ["--data-dir", os.path.join(str(workdir), "data")],
        cwd=str(workdir), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return tc.archives(os.path.join(str(workdir), "data"))


def run_ranks(module, args, data_dir, ranks):
    """The port's driver on `ranks` gloo ranks: (its output, the ranks'
    records, its archives)."""
    import contextlib
    import importlib
    import io
    mod = importlib.import_module(f"krylov_spdes_tpu_torch.examples.{module}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recs = mod.main(list(args)
                        + ["--cpu", "--ranks", str(ranks), "--data-dir",
                           str(data_dir)])
    return buf.getvalue(), recs, tc.archives(data_dir)


def _one(archives, suffix):
    (name,) = [n for n in archives if n.endswith(suffix)]
    return name, archives[name]


# --- Example 08: the sharded NN-PCG ----------------------------------------

EX08 = ["--nnode", "500", "--ndom", "8"]


@pytest.fixture(scope="module")
def ex08_jax(tmp_path_factory):
    return run_jax_devices("ex08_dd_parallel", EX08,
                           tmp_path_factory.mktemp("ex08_jax"))


@pytest.mark.parametrize("ranks", [2, 4])
def test_ex08_iters_equal_jax(ex08_jax, ranks, tmp_path):
    """ndom 8 on 2 or 4 ranks against the JAX driver's 8 devices: the same
    archive and the same `iters` (NN is symmetric, so equality holds in
    float64), rank 0's line first after the device line, every rank on
    gloo with the same count."""
    out, recs, P = run_ranks("ex08_dd_parallel", EX08, tmp_path, ranks)
    assert out.splitlines()[0] == (f"device cpu float64; {ranks} rank(s) "
                                   "over gloo")
    assert set(P) == set(ex08_jax)
    name, arc = _one(P, ".ndom8.ex08.npz")
    np.testing.assert_array_equal(arc["iters"], ex08_jax[name]["iters"])
    assert len(recs) == ranks
    assert {r["backend"] for r in recs} == {"gloo"}
    assert {r["value"]["it"] for r in recs} == {int(arc["iters"][0])}
    assert recs[0]["value"]["rel"] <= 1e-7
    assert all(r["value"]["psum_calls"] > 0 for r in recs)


def test_ex08_rounds_ndom_up_to_the_ranks(tmp_path):
    out, recs, P = run_ranks("ex08_dd_parallel",
                             ["--nnode", "500", "--ndom", "3"], tmp_path, 2)
    _one(P, ".ndom4.ex08.npz")
    assert "over 2 rank(s)" in out


def test_ranks_past_their_timeout_fail_the_driver(rank_timeout, tmp_path):
    """Ranks that outlive common.RANK_TIMEOUT are killed and the driver
    raises; nothing reruns and nothing is archived."""
    from krylov_spdes_tpu_torch.examples import common
    rank_timeout.setattr(common, "RANK_TIMEOUT", 0.5)
    with pytest.raises(TimeoutError, match="ranks still running"):
        run_ranks("ex08_dd_parallel", EX08, tmp_path, 2)
    assert not list(tmp_path.glob("*.npz"))


# --- Example 05: the distributed two-level KL -------------------------------

EX05 = ["--nnode", "400", "--ndom", "8", "--nev", "8", "--L", "0.4",
        "--local-eig", "eigh"]


def _m_cosines(Pa, Pb, M):
    """Cosines of the principal angles between span(Pa) and span(Pb) in
    the M inner product."""
    def orth(P):
        L = np.linalg.cholesky(P.T @ M @ P)
        return P @ np.linalg.inv(L).T
    Qa, Qb = orth(Pa), orth(Pb)
    return np.linalg.svd(Qa.T @ M @ Qb, compute_uv=False)


@pytest.mark.parametrize("pipeline", ["device", "host"])
def test_ex05_matches_jax(pipeline, tmp_path):
    """Both pipelines on 2 ranks against the JAX driver on 8 devices, dense
    local eigh on both sides: λ and the captured variance within 1e-10
    relative (ex04's tolerance); ψ by span, M-cosines ≥ 1 − 1e-8, since the
    square's mode pairs lie 2e-7 apart and a pair's basis rotates with the
    last bits."""
    flags = EX05 + (["--host-pipeline"] if pipeline == "host" else [])
    J = run_jax_devices("ex05_kl_dd_distributed", flags, tmp_path / "jax")
    out, recs, P = run_ranks("ex05_kl_dd_distributed", flags,
                             tmp_path / "port", 2)
    assert f"({pipeline} pipeline)" in out
    assert set(P) == set(J)
    name, pa = _one(P, ".ex05.kl-dd-pll.npz")
    ja = J[name]
    assert set(pa) == set(ja)
    assert pa["lam"].shape == ja["lam"].shape
    assert tc._rel(pa["lam"], ja["lam"]) <= 1e-10
    assert abs(float(pa["captured"]) - float(ja["captured"])) <= \
        1e-10 * float(ja["captured"])
    from krylov_spdes_tpu_torch import fem
    mesh = fem.get_mesh(400, jitter=0.2, seed=0)
    M = fem.get_mass_matrix(mesh.cells, mesh.points, dtype=torch.float64,
                            device="cpu").to_scipy().toarray()
    assert _m_cosines(pa["psi"], ja["psi"], M).min() >= 1 - 1e-8
    for r in recs:
        np.testing.assert_array_equal(r["value"]["lam"], pa["lam"])
    if pipeline == "device":
        assert recs[0]["value"]["psum_calls"] >= 1


def test_ex05_summary_only(tmp_path):
    out, recs, P = run_ranks("ex05_kl_dd_distributed",
                             EX05 + ["--summary-only"], tmp_path, 2)
    _, arc = _one(P, ".ex05.kl-dd-pll.summary.npz")
    assert set(arc) == {"lam", "wall", "captured", "relative_global",
                        "local_eig"}
    assert arc["local_eig"].item() == b"eigh"


def test_sharded_device_kl_shares_one_set_of_local_bases(tmp_path):
    """ex05's device pipeline on 2 ranks whose local eigensolvers return
    eigenvectors with signs of their own (on the card the batched eigh
    does not repeat them bit for bit: ex05's kept modes moved 511 -> 506
    when each rank solved every subdomain): the stage-A bases are split
    over the ranks and gathered, so λ and ψ equal the unsharded pipeline's
    in float64."""
    import torch_rank_fns as ranks
    from krylov_spdes_tpu_torch import fem, kl
    from krylov_spdes_tpu_torch.kl import dd_device
    from krylov_spdes_tpu_torch.parallel import launch
    mesh = fem.get_mesh(400, jitter=0.2, seed=0)
    epart, _ = fem.mesh_partition(mesh.cells, mesh.points, 8,
                                  mesh.cell_neighbors)
    lam, psi = dd_device.compute_dd_kl_device(
        mesh.cells, mesh.points, epart, 8, kl.make_cov("sexp", 1.0, 0.4),
        nev=8, forget=1e-6, dtype=torch.float64, device="cpu")
    out = launch(ranks.kl_sign_rank, 2,
                 args=(mesh.cells, mesh.points, epart, 8, 8, 0.4),
                 backend="gloo", device="cpu", timeout=240,
                 init_method=f"file://{tmp_path / 'rdv'}")
    for o in out:
        assert o["lam"].shape == lam.shape
        assert tc._rel(o["lam"], lam) <= 1e-10
    np.testing.assert_array_equal(out[0]["psi"], out[1]["psi"])


# --- Example 17: --fast --layout sharded -------------------------------------

EX17 = ["--nnode", "400", "--ndom", "4", "--nchains", "2", "--nsmp", "3",
        "--L", "0.4", "--fast", "--layout", "sharded"]


def test_ex17_sharded_matches_one_rank_and_batched_seeds(tmp_path):
    """2 chains on 2 gloo ranks: the iteration table equals the port's own
    one-rank run entry for entry, and its first sample (the
    seed_chains_batched seeds) equals --layout batched's, which seeds the
    same way. A torch generator cannot continue the JAX driver's keys, so
    the JAX arm is no yardstick here."""
    its = {}
    for ranks in (1, 2):
        out, recs, P = run_ranks("ex17_recyclers_mcmc", EX17,
                                 tmp_path / f"r{ranks}", ranks)
        _, arc = _one(P, ".ex17.fast.npz")
        its[ranks] = arc["iters"]
        assert len(recs) == ranks
        for r in recs:
            np.testing.assert_array_equal(r["value"]["iters"], arc["iters"])
    assert its[2].shape == (2, 3)
    np.testing.assert_array_equal(its[2], its[1])
    flags = [f for f in EX17 if f not in ("sharded",)]
    flags[flags.index("--layout") + 1:flags.index("--layout") + 1] = \
        ["batched"]
    tc.run_port("ex17_recyclers_mcmc", flags, tmp_path / "batched")
    _, batched = _one(tc.archives(tmp_path / "batched"), ".ex17.fast.npz")
    np.testing.assert_array_equal(its[2][:, 0], batched["iters"][:, 0])


def test_ex17_sharded_uses_at_most_one_rank_a_chain(tmp_path):
    """The JAX driver's mesh of min(nchains, devices) chain shards."""
    flags = list(EX17)
    flags[flags.index("--nchains") + 1] = "1"
    out, recs, P = run_ranks("ex17_recyclers_mcmc", flags, tmp_path, 2)
    assert len(recs) == 1 and "1 rank(s) over gloo" in out
    assert _one(P, ".ex17.fast.npz")[1]["iters"].shape == (1, 3)


# --- the scaling harness ------------------------------------------------------

HARNESS = ["--nnode", "300", "--doms-per-device", "2", "--reps", "5"]


@pytest.mark.parametrize("arm", ["matvec", "dd-chain"])
def test_scaling_harness(arm, tmp_path):
    """Both arms on 2 ranks: one row a rank count (1 and 2, the mesh and
    the subdomains growing with the ranks), each saying where its ranks
    ran; the psum count of the step's program (sites a step, the JAX
    harness's HLO all-reduce count) or of a matvec the same at every rank
    count."""
    flags = HARNESS + (["--dd-chain"] if arm == "dd-chain" else [])
    out, recs, _ = run_ranks("scaling_harness", flags, tmp_path, 2)
    rows = recs[0]["value"]
    assert [r["ranks"] for r in rows] == [1, 2]
    assert [r["ndom"] for r in rows] == [2, 4]
    assert rows[1]["nnode"] > rows[0]["nnode"]
    assert all("on the CPU" in r["sharing"] for r in rows)
    # rank 1 sits in the 2-rank mesh only
    assert [r["ranks"] for r in recs[1]["value"]] == [2]
    lines = [ln for ln in out.splitlines() if ln.startswith("ranks=")]
    if arm == "matvec":
        assert len(lines) == 4           # two rows + two efficiency lines
        assert {r["psum_calls_per_matvec"] for r in rows} == {1}
        assert all(r["ms_per_matvec"] > 0 for r in rows)
    else:
        assert len(lines) == 2
        assert len({r["psum_sites"] for r in rows}) == 1
        assert all(r["psum_calls"] >= r["psum_sites"] > 0 for r in rows)
        assert all(0 < r["its"] < 400 for r in rows)
        assert "psum sites/step = [" in out
