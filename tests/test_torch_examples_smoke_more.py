"""PyTorch port, the example drivers must keep running end to end (float64
on the CPU, in this process): the port's counterpart of every case in
EXTRA_DEFAULT_CASES and MORE_CASES of tests/test_examples_smoke.py at the
same arguments, and the drivers' other arms: the certified solves (held to
their 1e-7 certificate), resumes (a resumed run must repeat the
uninterrupted one), Example 06's conditioning and spectra, Example 09's
preconditioners, Example 17's layouts, the Cholesky factorizations and
codebooks of the quantization drivers, and the two-level KL basis."""

import numpy as np
import pytest
import torch

import torch_example_cases as tc

torch.set_num_threads(1)

MORE = tc.EXTRA_DEFAULT_CASES + tc.MORE_CASES
BASE = ["--nnode", "400", "--ndom", "4", "--L", "0.4"]


@pytest.mark.parametrize("case", MORE, ids=[tc.case_id(c) for c in MORE])
def test_more_examples(case, tmp_path):
    module, args = case
    out = tc.run_port(module, args, tmp_path)
    assert "saved" in out
    tc.check_archives(tmp_path)


def _archive(tmp_path, suffix):
    A = tc.check_archives(tmp_path)
    (f,) = [f for f in A if f.endswith(suffix)]
    return A[f]


def _certified(d):
    keys = [k for k in d if k.startswith("certres_")]
    assert keys and float(d["certified_rtol"]) == 1e-7
    for k in keys:
        assert np.all(d[k] <= 1e-7), (k, d[k])


def test_ex03_experimental_preconditioners(tmp_path):
    out = tc.run_port("ex03_dd_schur", ["--nnode", "500", "--ndom", "4",
                                        "--with-ddlr", "--with-nn-induced"],
                      tmp_path)
    assert "DDLR-PCG" in out and "NN-induced eigdefpcg" in out


def test_ex06_certified(tmp_path):
    tc.run_port("ex06_pcg_stochastic",
                BASE + ["--nreals", "1", "--certify", "--strategies",
                        "amg,lorasc,bj,samg"], tmp_path)
    d = _archive(tmp_path, ".ex06.iters.npz")
    _certified(d)
    assert len([k for k in d if k.startswith("certres_")]) == 8


def test_ex06_conditioning_and_spectra(tmp_path):
    tc.run_port("ex06_pcg_stochastic",
                BASE + ["--nreals", "1", "--save-conditioning",
                        "--save-spectra", "--strategies", "amg,bj"], tmp_path)
    d = _archive(tmp_path, ".ex06.iters.npz")
    assert d["kappa_amg"][0] > 1 and d["kappa_bj"][0] > 1
    w = d["spectra"][0]
    assert w.shape == (324,) and w[0] > 0 and np.all(np.diff(w) >= 0)


def test_ex06_resume_repeats_the_run(tmp_path):
    args = BASE + ["--strategies", "bj,samg"]
    tc.run_port("ex06_pcg_stochastic", args + ["--nreals", "2"],
                tmp_path / "whole")
    tc.run_port("ex06_pcg_stochastic", args + ["--nreals", "1"],
                tmp_path / "split")
    out = tc.run_port("ex06_pcg_stochastic",
                      args + ["--nreals", "2", "--resume"],
                      tmp_path / "split")
    assert "1/2 done" in out
    whole = _archive(tmp_path / "whole", ".ex06.iters.npz")
    split = _archive(tmp_path / "split", ".ex06.iters.npz")
    for k in ("bj_const", "bj_rebuilt", "samg_const", "samg_rebuilt"):
        np.testing.assert_array_equal(split[k], whole[k])


@pytest.mark.parametrize("interiors", ["dense", "banded"])
def test_ex07_certified(interiors, tmp_path):
    mesh = ["--mesh", "delaunay"] if interiors == "banded" else []
    tc.run_port("ex07_pcg_schur_stochastic",
                BASE + mesh + ["--nreals", "1", "--certify", "--interiors",
                               interiors], tmp_path)
    _certified(_archive(tmp_path, ".ex07.iters.npz"))


def test_ex07_resume_repeats_the_run(tmp_path):
    tc.run_port("ex07_pcg_schur_stochastic", BASE + ["--nreals", "2"],
                tmp_path / "whole")
    tc.run_port("ex07_pcg_schur_stochastic", BASE + ["--nreals", "1"],
                tmp_path / "split")
    out = tc.run_port("ex07_pcg_schur_stochastic",
                      BASE + ["--nreals", "2", "--resume"],
                      tmp_path / "split")
    assert "1/2 done" in out
    whole = _archive(tmp_path / "whole", ".ex07.iters.npz")
    split = _archive(tmp_path / "split", ".ex07.iters.npz")
    for k in ("nn_const", "nn_rebuilt", "gamma_chol"):
        np.testing.assert_array_equal(split[k], whole[k])


def test_ex09_certified(tmp_path):
    tc.run_port("ex09_defpcg_mcmc", BASE + ["--nchains", "1", "--nsmp", "2",
                                            "--certify"], tmp_path)
    d = _archive(tmp_path, ".ex09.iters.npz")
    _certified(d)
    assert d["status"].tolist() == [0]


@pytest.mark.parametrize("precond", ["bj", "lorasc0"])
def test_ex09_preconditioners(precond, tmp_path):
    tc.run_port("ex09_defpcg_mcmc", BASE + ["--nchains", "1", "--nsmp", "2",
                                            "--precond", precond], tmp_path)
    d = _archive(tmp_path, f".ex09.iters.{precond}.npz")
    assert d["status"].tolist() == [0] and d["pcg"].shape == (1, 2)


def test_ex09_resume_skips_done_chains(tmp_path):
    args = BASE + ["--nsmp", "2", "--nchains", "2"]
    tc.run_port("ex09_defpcg_mcmc", args, tmp_path)
    f = tmp_path / "SExp_sig21.0_L0.4_DoF400.ndom4.ex09.iters.npz"
    whole = dict(np.load(f))
    # the periodic archive of a run cut after its first chain
    cut = {k: whole[k].copy() for k in ("status", "pcg", "eigpcg",
                                        "eigdefpcg", "defpcg")}
    for v in cut.values():
        v[1:] = 0
    np.savez(f, ndone_chain=np.int64(1), **cut)
    out = tc.run_port("ex09_defpcg_mcmc", args + ["--resume"], tmp_path)
    assert "chains 0..0 loaded" in out
    resumed = np.load(f)
    for k in ("pcg", "eigpcg", "eigdefpcg", "defpcg", "status"):
        np.testing.assert_array_equal(resumed[k], whole[k])


def test_ex17_fast_layouts_agree(tmp_path):
    args = BASE + ["--nchains", "2", "--nsmp", "3", "--fast"]
    its = {}
    for layout in ("batched", "vmap"):
        tc.run_port("ex17_recyclers_mcmc", args + ["--layout", layout],
                    tmp_path / layout)
        its[layout] = _archive(tmp_path / layout, ".ex17.fast.npz")["iters"]
    assert its["vmap"].shape == (2, 3)
    np.testing.assert_array_equal(its["vmap"], its["batched"])


def test_ex17_sharded_layout_is_refused(tmp_path):
    with pytest.raises(SystemExit) as e:
        tc.run_port("ex17_recyclers_mcmc",
                    BASE + ["--fast", "--layout", "sharded"], tmp_path)
    assert "17b" in str(e.value.code)
    assert not list(tmp_path.iterdir())


def test_ex17_certified(tmp_path):
    tc.run_port("ex17_recyclers_mcmc", BASE + ["--nchains", "1", "--nsmp",
                                               "2", "--certify"], tmp_path)
    d = _archive(tmp_path, ".ex17.iters.npz")
    _certified(d)
    assert len([k for k in d if k.startswith("certres_")]) == 7


def test_ex17_resume_mid_chain_is_bit_identical(tmp_path):
    args = BASE + ["--nchains", "1", "--methods", "lotrhr,rr"]
    tc.run_port("ex17_recyclers_mcmc", args + ["--nsmp", "3"],
                tmp_path / "whole")
    tc.run_port("ex17_recyclers_mcmc", args + ["--nsmp", "2"],
                tmp_path / "split")
    out = tc.run_port("ex17_recyclers_mcmc",
                      args + ["--nsmp", "3", "--resume"], tmp_path / "split")
    assert "chain 0 sample 2" in out
    sfx = ".ex17.iters.lotrhr,rr.npz"
    whole = _archive(tmp_path / "whole", sfx)
    split = _archive(tmp_path / "split", sfx)
    for k in ("pcg", "rr", "lotrhr"):
        np.testing.assert_array_equal(split[k], whole[k])


def test_ex11_block_rhs(tmp_path):
    tc.run_port("ex11_multiple_rhs", ["--nnode", "300", "--nreals", "2",
                                      "--L", "0.4", "--block-rhs", "2"],
                tmp_path)
    d = _archive(tmp_path, ".ex11.iters.npz")
    assert d["blockpcg"].shape == (2,) and d["blockpcg"][0] > 1


@pytest.mark.parametrize("factor", ["banded", "stencil"])
def test_ex12_cholesky_factors(factor, tmp_path):
    its = {}
    for f in ("dense", factor):
        tc.run_port("ex12_quantization",
                    ["--nnode", "400", "--nreals", "1", "--P", "3", "--L",
                     "0.4", "--factor", f], tmp_path / f)
        its[f] = _archive(tmp_path / f, ".ex12.npz")["iters"]
    # the same float32 Cholesky factor of the same matrix, dense or not
    assert abs(int(its[factor][0]) - int(its["dense"][0])) <= 2


@pytest.mark.parametrize("codebook", ["grid", "cdf"])
def test_ex20_codebooks(codebook, tmp_path):
    tc.run_port("ex20_quantized_precond",
                ["--nnode", "300", "--nreals", "1", "--P", "3", "--L", "0.4",
                 "--codebook", codebook], tmp_path)
    entries = 2 ** 4 + 1 if codebook == "grid" else 3   # --nKL-trunc 4
    _archive(tmp_path, f".P{entries}.ex20.npz")


def test_ex02_two_level_basis(tmp_path):
    out = tc.run_port("ex02_karhunen_loeve",
                      ["--nnode", "300", "--nev", "10", "--L", "0.4",
                       "--kl-method", "dd"], tmp_path)
    assert "kept" in out
    A = tc.check_archives(tmp_path)
    assert any(f.endswith(".kl10.dd.npz") for f in A)


def test_postproc_reads_port_archives(tmp_path):
    """examples/postproc.py plots the port's archives as it plots the JAX
    package's: Example 17's iteration table and Example 02's field."""
    import subprocess
    import sys
    tc.run_port("ex17_recyclers_mcmc", BASE + ["--nchains", "1", "--nsmp",
                                               "2", "--methods", "rr"],
                tmp_path)
    tc.run_port("ex02_karhunen_loeve", ["--nnode", "400", "--nev", "10",
                                        "--L", "0.4"], tmp_path)
    root = "SExp_sig21.0_L0.4_DoF400"
    for cmd, archive in (("iters", f"{root}.ndom4.ex17.iters.rr.npz"),
                         ("field", f"{root}.ex02.kl.npz")):
        out = tmp_path / f"{cmd}.png"
        r = subprocess.run([sys.executable, "postproc.py", cmd,
                            str(tmp_path / archive), str(out)],
                           cwd=tc.EXDIR, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        assert out.stat().st_size > 0
