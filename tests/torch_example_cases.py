"""Cases and runners shared by the tests of the port's example drivers
(tests/test_torch_examples_*.py).

The cases are those of tests/test_examples_smoke.py (CASES,
EXTRA_DEFAULT_CASES, MORE_CASES) at the same arguments. A JAX driver runs
as that file runs it: a subprocess with --cpu, PYTHONPATH=examples/, in a
directory of its own. A port driver runs in this process through its
`main(argv)` with --cpu (float64 on the CPU) and --data-dir.
"""

import contextlib
import glob
import importlib
import io
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXDIR = os.path.join(ROOT, "examples")

CASES = [
    ("ex01_elliptic_pde", ["--nnode", "400"]),
    ("ex01_elliptic_pde", ["--nnode", "400", "--precond", "stencil-amg"]),
    ("ex01_elliptic_pde", ["--nnode", "400", "--mesh", "delaunay",
                           "--op", "banded"]),
    ("ex03_dd_schur", ["--nnode", "500", "--ndom", "4"]),
    ("ex09_defpcg_mcmc", ["--nnode", "400", "--ndom", "4", "--nchains", "1",
                          "--nsmp", "2", "--L", "0.4"]),
    ("ex12_quantization", ["--nnode", "300", "--nreals", "1", "--P", "3",
                           "--L", "0.4"]),
    ("ex17_recyclers_mcmc", ["--nnode", "400", "--ndom", "4", "--nchains",
                             "1", "--nsmp", "2", "--L", "0.4", "--fast"]),
    ("ex10_large_deterministic", ["--nnode", "2500"]),
    ("ex11_multiple_rhs", ["--nnode", "500", "--ndom", "4", "--nreals", "2",
                           "--schur", "--block-rhs", "2", "--L", "0.4"]),
    ("ex13_clvq", ["--ns", "500", "--Ps", "4", "--nKLs", "4", "--nnode",
                   "300", "--L", "0.4"]),
    ("ex18_clustering2d", ["--ns", "300", "--P", "3", "--nnode", "300",
                           "--L", "0.4"]),
]

EXTRA_DEFAULT_CASES = [
    ("ex02_karhunen_loeve", ["--nnode", "300", "--nev", "10", "--L", "0.4"]),
    ("ex07_pcg_schur_stochastic", ["--nnode", "400", "--ndom", "4",
                                   "--nreals", "1", "--L", "0.4"]),
    ("ex07_pcg_schur_stochastic", ["--nnode", "400", "--ndom", "4",
                                   "--nreals", "1", "--L", "0.4",
                                   "--mesh", "delaunay",
                                   "--interiors", "banded"]),
    ("ex09_defpcg_mcmc", ["--nnode", "400", "--ndom", "4", "--nchains", "1",
                          "--nsmp", "2", "--precond", "lorasc1",
                          "--L", "0.4"]),
    ("ex11_multiple_rhs", ["--nnode", "300", "--nreals", "2", "--L", "0.4"]),
    ("ex17_recyclers_mcmc", ["--nnode", "400", "--ndom", "4", "--nchains",
                             "1", "--nsmp", "2", "--L", "0.4"]),
]

MORE_CASES = [
    ("ex04_kl_dd", ["--nnode", "400", "--ndom", "4", "--nev", "10",
                    "--L", "0.4"]),
    ("ex06_pcg_stochastic", ["--nnode", "400", "--ndom", "4", "--nreals",
                             "1", "--strategies", "bj,samg", "--L", "0.4"]),
    ("ex14_shepard", ["--nnode", "300", "--nreals", "1", "--P", "3",
                      "--L", "0.4"]),
    ("ex15_sampling_overcost", ["--nnode", "300", "--nreals", "1",
                                "--L", "0.4"]),
    ("ex16_mcmc_realizations", ["--nnode", "300", "--lengths", "0,2",
                                "--L", "0.4"]),
    ("ex19_truncated_preconds", ["--nnode", "300", "--ks", "0,2",
                                 "--L", "0.4"]),
    ("ex20_quantized_precond", ["--nnode", "300", "--nreals", "1", "--P",
                                "3", "--L", "0.4"]),
]

ALL_CASES = CASES + EXTRA_DEFAULT_CASES + MORE_CASES


def case_id(case):
    """A readable test id: the driver's number and its arm's flags."""
    mod, args = case
    tags = [a.lstrip("-") for a in args if a in ("--fast", "--schur")]
    tags += [args[i + 1] for i, a in enumerate(args)
             if a in ("--precond", "--mesh", "--op", "--interiors",
                      "--strategies")]
    return "-".join([mod.split("_")[0]] + tags)


def run_port(module, args, data_dir):
    """The port's driver in this process on the CPU. Returns its standard
    output; raises what the driver raises."""
    mod = importlib.import_module(f"krylov_spdes_tpu_torch.examples.{module}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(list(args) + ["--cpu", "--data-dir", str(data_dir)])
    return buf.getvalue()


def run_jax(module, args, workdir):
    """The JAX driver as tests/test_examples_smoke.py runs it; its archives
    go to workdir/data. Returns its standard output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = EXDIR + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, os.path.join(EXDIR, module + ".py"), "--cpu"]
        + list(args) + ["--data-dir", os.path.join(str(workdir), "data")],
        cwd=str(workdir), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def archives(data_dir):
    """{file name: {key: array}} of the NPZ files a run wrote."""
    out = {}
    for path in sorted(glob.glob(os.path.join(str(data_dir), "*.npz"))):
        with np.load(path) as d:
            out[os.path.basename(path)] = {k: d[k] for k in d.files}
    return out


def check_archives(data_dir):
    """Every archive a run wrote holds finite numbers. Returns them."""
    A = archives(data_dir)
    assert A
    for f, arrays in A.items():
        for k, v in arrays.items():
            if v.dtype.kind in "fi":
                assert np.all(np.isfinite(v)), (f, k)
    return A


# Drivers whose every input is given by their flags: numpy's seeded
# generator (ex03, ex10, ex11) or none at all (ex01). Their iteration
# counts must equal the JAX driver's.
EQUAL_ITERS = {"ex01_elliptic_pde", "ex03_dd_schur",
               "ex10_large_deterministic", "ex11_multiple_rhs"}
# Their float results (Example 01's solution u) within 1e-8 relative of the
# JAX driver's: the same iterations in float64 on the same system differ
# only by the order of the sums. Timings differ from run to run, and
# Example 03's two cross-checks are float64 rounding differences that
# agree with the JAX driver's only within the bound each is held to
# (test_torch_examples_parity.py: the Schur apply 1e-12, DD against the
# monolithic solve 1e-8).
FLOAT_RTOL = 1e-8
TIMINGS = {"time_s"}
CROSS_CHECKS = {"apply_err": 1e-12, "sol_err": 1e-8}
# Drivers whose KL eigenvalues are deterministic (dense generalized
# eigensolves at these sizes, and the two-level pipeline of ex04): λ within
# 1e-10 relative of the JAX driver's.
EQUAL_LAMBDA = {"ex02_karhunen_loeve": "ex02.kl",
                "ex04_kl_dd": "ex04.kl-dd"}
# The rest draw their samples from a PRNG key in the JAX driver and from a
# torch generator seeded alike in the port (ex06, ex07, ex09, ex12-ex20's
# samplers, ex13/ex18's sample sets, ex17's chains): no flag can hand
# either driver the other's draws, so these are held to the archives'
# names, keys and shapes here, and to finishing (tests/
# test_torch_examples_smoke*.py).
LAMBDA_RTOL = 1e-10
# the chain drivers (test_torch_examples_parity_chains.py)
CHAIN_DRIVERS = {"ex07_pcg_schur_stochastic", "ex09_defpcg_mcmc",
                 "ex17_recyclers_mcmc"}


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def check_parity(case, tmp_path):
    """Run a case through both drivers and hold the port's archives to the
    JAX driver's: the same file names, keys and shapes, and, where the
    driver is deterministic, the same iteration counts and float results
    or eigenvalues.

    Two differences are by design. A chain checkpoint's `key` holds the
    JAX package's PRNG key (2 words) in one and the torch generator's state
    in the other (utils/persistence.py::save_chain_checkpoint). Example 17's
    resume state keeps the sampler's pytree leaves (`smp_0`, ...) in the
    JAX driver; the port keeps the sampler in a chain checkpoint of its own
    beside the state file (`<state>.sampler.npz`)."""
    module, args = case
    (tmp_path / "jax").mkdir()
    run_jax(module, args, tmp_path / "jax")
    out = run_port(module, args, tmp_path / "port")
    assert "saved" in out
    J = archives(tmp_path / "jax" / "data")
    P = archives(tmp_path / "port")
    assert J, "the JAX driver wrote no archive"
    extra = {f for f in P if f.endswith(".state.sampler.npz")}
    assert set(P) - extra == set(J)
    for f in extra:
        assert f.replace(".sampler.npz", ".npz") in J
    for f, jd in J.items():
        pd = P[f]
        jkeys = {k for k in jd if not (".state" in f and k.startswith("smp_"))}
        assert set(pd) == jkeys, (f, set(pd) ^ jkeys)
        for k in jkeys:
            if ".ckpt" in f and k == "key":
                continue
            assert pd[k].shape == jd[k].shape, (f, k, pd[k].shape,
                                                jd[k].shape)
        if ".seed" in f and "lam" in jd:     # the cached KL basis
            assert _rel(pd["lam"], jd["lam"]) <= LAMBDA_RTOL, f
    if module in EQUAL_ITERS:
        for f, jd in J.items():
            for k, v in jd.items():
                if v.dtype.kind == "i" and k not in ("nvec", "spdim"):
                    np.testing.assert_array_equal(P[f][k], v, err_msg=f"{f}:{k}")
                elif k in CROSS_CHECKS:
                    assert abs(float(P[f][k]) - float(v)) <= CROSS_CHECKS[k], \
                        (f, k, P[f][k], v)
                elif v.dtype.kind == "f" and k not in TIMINGS:
                    np.testing.assert_allclose(
                        P[f][k], v, rtol=FLOAT_RTOL,
                        atol=FLOAT_RTOL * float(np.max(np.abs(v))),
                        err_msg=f"{f}:{k}")
    if module in EQUAL_LAMBDA:
        (f,) = [f for f in J if EQUAL_LAMBDA[module] in f]
        assert _rel(P[f]["lam"], J[f]["lam"]) <= LAMBDA_RTOL
    return J, P
