"""PyTorch port, the root measurement drivers' twins
(krylov_spdes_tpu_torch/bench/bench_{amg,banded,chain,dd_chain,
vmem_eigdef,vmem_stretch}.py) through their `main(["--cpu"])` at small
BENCH_NNODE, in float64 on the CPU: each prints the JSON lines of its JAX
file under the same keys (read from the JAX file itself), its solves stay
below their maxit, and the paths it compares agree. On the CPU kernel E
runs as its plain version `stretch_coef_plain` and kernel A as
`stencil_spmv_plain`.

The deterministic drivers (bench_amg, bench_banded, bench_vmem_eigdef,
bench_vmem_stretch: numpy seeds only) are also held to the root JAX files
run at the same BENCH_* in a subprocess, on the CPU in float64, kernel E's
pallas calls in interpret mode as the JAX package's own tests run them.
bench_chain and bench_dd_chain draw their chains from `jax.random` keys,
which a torch generator cannot continue, so they are held to themselves."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_bench_cases import ROOT, jax_json_keys, run_bench

# BENCH_* of the runs held to the JAX files, the same for both packages
SIZES = {
    "bench_amg": dict(NNODE=10000, NSOLVE=2),
    "bench_banded": dict(NNODE=3000, NDOM=4, ENVELOPE=1, ENV_NNODE=3000,
                         ENV_NDOM=4),
    "bench_vmem_eigdef": dict(NNODE=2500, NVEC=4),
    "bench_vmem_stretch": dict(NNODE=900, NVEC=16),
}
# code run before a JAX file, which then runs as __main__ (sys.argv[1])
PRELUDE = {
    # kernel E's pallas calls in interpret mode
    "vmem": ("import functools\n"
             "import krylov_spdes_tpu.ops.vmem_eigdef as ve\n"
             "ve.vmem_eigdefpcg = functools.partial(ve.vmem_eigdefpcg, "
             "interpret=True)\n"
             "ve._stretch_call = functools.partial(ve._stretch_call, "
             "interpret=True)\n"),
    # every pcg call's `it` and x kept, written to pcg_calls.npz at exit
    "pcg": ("import atexit, importlib\n"
            "import numpy as np\n"
            "cg = importlib.import_module('krylov_spdes_tpu.solvers.cg')\n"
            "_pcg, _got = cg.pcg, []\n"
            "def pcg(*a, **k):\n"
            "    res = _pcg(*a, **k)\n"
            "    _got.append((int(res.it), np.asarray(res.x)))\n"
            "    return res\n"
            "cg.pcg = pcg\n"
            "atexit.register(lambda: np.savez('pcg_calls.npz', it=[g[0] for "
            "g in _got], **{f'x{i}': g[1] for i, g in enumerate(_got)}))\n"),
}
RUN_MAIN = ("import runpy, sys\n"
            "runpy.run_path(sys.argv[1], run_name='__main__')\n")


class JaxBenches:
    """The root JAX files of SIZES, all started at once in subprocesses
    (JAX on the CPU in float64, no compilation cache), each in a directory
    of its own, read on demand."""

    def __init__(self, workdir):
        self.procs, self.dirs = {}, {}
        for name, sizes in SIZES.items():
            env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
                       KRYLOV_JAX_CACHE="off",
                       PYTHONPATH=ROOT + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            env.update({f"BENCH_{k}": str(v) for k, v in sizes.items()})
            prelude = PRELUDE["vmem" if "vmem" in name else "pcg"]
            self.dirs[name] = os.path.join(str(workdir), name)
            os.makedirs(self.dirs[name])
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-c", prelude + RUN_MAIN,
                 os.path.join(ROOT, f"{name}.py")], cwd=self.dirs[name],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        self.outs = {}

    def out(self, name):
        """(its JSON lines, its output) once it has ended."""
        if name not in self.outs:
            p = self.procs[name]
            so, se = p.communicate(timeout=600)
            assert p.returncode == 0, (so[-2000:], se[-2000:])
            self.outs[name] = so
        so = self.outs[name]
        return ([json.loads(ln) for ln in so.splitlines()
                 if ln.startswith("{")], so)

    def pcg_calls(self, name):
        """(`it`, x) of each pcg call the JAX file made, in order."""
        self.out(name)
        with np.load(os.path.join(self.dirs[name], "pcg_calls.npz")) as d:
            return [(int(it), d[f"x{i}"]) for i, it in enumerate(d["it"])]

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_benches(tmp_path_factory):
    runs = JaxBenches(tmp_path_factory.mktemp("jax_benches"))
    yield runs
    runs.close()


def label_its(out):
    """{label: its} of the `# <label>: <t> ms / <its> its` lines."""
    return {m[1]: int(m[2]) for m in
            re.finditer(r"^# (.+?): [\d.]+ ms / (\d+) its", out, re.M)}


def int_fields(out, prefix):
    """The `name=<int>` fields of the output line that starts with
    prefix."""
    (line,) = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    return dict(re.findall(r"(\w+(?: max)?)[= ](\d+)", line))


def _keys(lines):
    return [list(d) for d in lines]


def test_bench_chain(monkeypatch):
    r, lines, out = run_bench("bench_chain", monkeypatch, NNODE=2500, NVEC=4)
    assert _keys(lines) == jax_json_keys("bench_chain")
    assert lines[0]["metric"] == "chain_time_per_realization"
    assert lines[0]["vs_baseline"] == 1.0      # BENCH_BASELINE unset
    assert f"iters_per_sample={r['iters']}" in out
    assert len(r["iters"]) == 3
    assert max(r["iters"] + [r["seed_it"], r["warm_it"]]) < r["maxit"]


@pytest.mark.parametrize("plan,nchains", [("stencil", 1), ("scatter", 2)])
def test_bench_dd_chain(plan, nchains, monkeypatch):
    r, lines, out = run_bench("bench_dd_chain", monkeypatch, NNODE=2000,
                              NDOM=4, NVEC=4, PLAN=plan, NCHAINS=nchains)
    assert _keys(lines) == jax_json_keys("bench_dd_chain")[:1] == \
        jax_json_keys("bench_dd_chain")[1:]
    assert lines[0]["metric"] == "dd_chain_time_per_realization"
    assert "# ndom=4 nI=" in out
    its = np.asarray(r["iters"] + r["warm_iters"])
    assert its.size == 9 * nchains and 0 < its.min() and its.max() < r["maxit"]
    assert ("# batched layout: 2 chains" in out) == (nchains == 2)
    assert ("# breakdown: refill=" in out) == (nchains == 1)
    assert min(r["refill_ms"], r["condense_ms"], r["nn_ms"]) > 0
    if nchains == 1:        # the field of every solve, for a later look
        assert len(r["fields"]) == len(r["its_all"]) == 10
        assert r["its_all"] == [r["seed_it"]] + r["warm_iters"] + r["iters"]


def test_bench_amg(monkeypatch, jax_benches):
    """The JAX file's line equal in nnode, nnz, rtol, levels and both
    iteration counts (float64, numpy seed 0: the same system and the same
    solvers)."""
    r, lines, _ = run_bench("bench_amg", monkeypatch, **SIZES["bench_amg"])
    assert _keys(lines) == jax_json_keys("bench_amg")
    d = lines[0]
    assert d["metric"] == "amg_pcg_1m" and d["nnode"] == 10000
    assert d["levels"] >= 2 and d["setup_ms"] > 0
    assert max(r["amg_its"]) < r["amg_maxit"] and max(r["cg_its"]) < \
        r["cg_maxit"]
    assert d["amg_iters"] < d["cg_iters"]
    # the scaled right-hand sides converge alike; both solutions of the
    # last one to rtol of each other
    St, b = r["St"], r["b"] * r["scale"]
    for x in (r["x_amg"], r["x_cg"]):
        assert torch.linalg.vector_norm(b - St(x)) <= \
            r["rtol"] * torch.linalg.vector_norm(b) * (1 + 1e-6)
    assert float(torch.linalg.vector_norm(r["x_amg"] - r["x_cg"]) /
                 torch.linalg.vector_norm(r["x_cg"])) <= 1e-4
    (dj,), _ = jax_benches.out("bench_amg")
    for k in ("nnode", "nnz", "rtol", "levels", "amg_iters", "cg_iters"):
        assert d[k] == dj[k], (k, d[k], dj[k])


def test_bench_banded(monkeypatch, jax_benches):
    """ELL and banded Jacobi-PCG give the same `it` (within one) and the
    unpermuted x within 1e-5 (tests/test_torch_banded.py's limits); the
    banded interiors' Schur blocks equal the dense ones; the opt-in
    envelope arm runs the no-dense-interior pipeline.

    Against the JAX file: the band (m, nb), the DD interiors (nI, m, nb,
    bw max), the envelope's sizes, `interface_its` and the Schur parity
    are equal; both x within 1e-5 of its ELL solve's (its pcg calls
    recorded). Each Jacobi-PCG `it` is held within one of the JAX file's:
    the two systems agree to their last bits, and over some 200
    iterations the two packages' float64 residual histories part far
    enough that the last step lands either side of the tolerance (219 in
    JAX, 218 in the port at this size)."""
    r, lines, out = run_bench("bench_banded", monkeypatch,
                              **SIZES["bench_banded"])
    assert _keys(lines) == jax_json_keys("bench_banded")
    assert abs(r["it_ell"] - r["it_banded"]) <= 1
    assert max(r["it_ell"], r["it_banded"]) < r["maxit"]
    np.testing.assert_allclose(r["x_banded"].numpy(), r["x_ell"].numpy(),
                               rtol=1e-5, atol=1e-8)
    assert lines[1]["parity_relerr"] <= 1e-10
    assert 0 < lines[2]["interface_its"] < 200
    assert lines[2]["peak_device_gb"] == 0.0       # no card here
    lj, oj = jax_benches.out("bench_banded")
    its_j = label_its(oj)
    assert abs(r["it_ell"] - its_j["ell-gather Jacobi-PCG"]) <= 1
    assert abs(r["it_banded"] - its_j["rcm-banded Jacobi-PCG"]) <= 1
    # the JAX file's ELL solves (a warm one and three timed) come first
    calls = jax_benches.pcg_calls("bench_banded")
    assert [it for it, _ in calls[:4]] == [its_j["ell-gather Jacobi-PCG"]] * 4
    for x in (r["x_ell"], r["x_banded"]):
        np.testing.assert_allclose(x.numpy(), calls[0][1], rtol=1e-5,
                                   atol=1e-8)
    for prefix in ("# banded: bw-block", "# DD interiors:", "# envelope:"):
        assert int_fields(out, prefix) == int_fields(oj, prefix), prefix
    assert lines[1]["parity_relerr"] == lj[1]["parity_relerr"]
    for k in ("value", "interface_its", "dense_would_need_gb",
              "banded_blocks_gb"):
        assert lines[2][k] == lj[2][k], (k, lines[2][k], lj[2][k])


def test_bench_vmem_eigdef(monkeypatch, jax_benches):
    """Kernel E's path (its plain version here) against the host-looped
    twin: the same `it`, x within 1e-8, as tests/test_torch_vmem_eigdef.py
    holds the two; both `it` equal to the JAX file's twin and kernel."""
    r, lines, out = run_bench("bench_vmem_eigdef", monkeypatch,
                              **SIZES["bench_vmem_eigdef"])
    assert _keys(lines) == jax_json_keys("bench_vmem_eigdef")
    assert r["it_vmem"] == r["it_twin"] < r["maxit"]
    assert r["seed_it"] < r["maxit"]
    np.testing.assert_allclose(r["x_vmem"].numpy(), r["x_twin"].numpy(),
                               rtol=1e-8, atol=1e-12)
    assert "speedup vs host-looped twin" in out
    _, oj = jax_benches.out("bench_vmem_eigdef")
    its_j = label_its(oj)
    assert (r["it_twin"], r["it_vmem"]) == (its_j["xla fused eigDef-PCG"],
                                            its_j["vmem stretch kernel"])


def test_bench_vmem_stretch(monkeypatch, jax_benches):
    """The sweep at nvec 16 (spdim 48: every nsteps point fits V), each
    stretch running all its nsteps against a tolerance never met; the
    full solver at both spdim values with the twin's `it` and x, and
    every `it` equal to the JAX file's solver and twin."""
    r, lines, out = run_bench("bench_vmem_stretch", monkeypatch,
                              **SIZES["bench_vmem_stretch"])
    assert _keys(lines) == jax_json_keys("bench_vmem_stretch")
    assert r["nsteps"] == [1, 3, 7, 15, 31, 46]
    assert r["sweep_calls"] == len(r["nsteps"]) * (1 + 3 * r["nq"])
    for n in r["nsteps"]:
        assert f"nsteps={n:3d}:" in out and f"ran {n})" in out
    for sp in (48, 80):
        assert r["its"][f"vmem_sp{sp}"] == r["its"][f"twin_sp{sp}"] < 400
        np.testing.assert_allclose(r["x"][f"vmem_sp{sp}"].numpy(),
                                   r["x"][f"twin_sp{sp}"].numpy(), rtol=1e-8,
                                   atol=1e-12)
    _, oj = jax_benches.out("bench_vmem_stretch")
    its_j = label_its(oj)
    for sp in (48, 80):
        assert r["its"][f"vmem_sp{sp}"] == its_j[f"vmem solver spdim={sp}"]
        assert r["its"][f"twin_sp{sp}"] == its_j[f"xla twin spdim={sp}"]
