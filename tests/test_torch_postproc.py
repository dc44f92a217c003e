"""PyTorch port, examples/postproc.py (krylov_spdes_tpu_torch/examples/
postproc.py) on the port's archives: the iteration curves of Example 17
and Example 09, a field of Example 02 on the port's mesh, and a partition
from the port's partitioner, each a non-empty PNG. matplotlib is there on
this host; the module imports it only inside the plotting functions."""

import numpy as np
import pytest

import torch_example_cases as tc
from krylov_spdes_tpu_torch.examples import postproc

BASE = ["--nnode", "400", "--ndom", "4", "--L", "0.4"]
ROOT = "SExp_sig21.0_L0.4_DoF400"


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    d = tmp_path_factory.mktemp("postproc")
    tc.run_port("ex17_recyclers_mcmc", BASE + ["--nchains", "2", "--nsmp",
                                               "3", "--fast"], d)
    tc.run_port("ex09_defpcg_mcmc", BASE + ["--nchains", "1", "--nsmp", "2"],
                d)
    tc.run_port("ex02_karhunen_loeve", ["--nnode", "400", "--nev", "10",
                                        "--L", "0.4"], d)
    return d


def _png(path):
    assert path.stat().st_size > 0
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("archive", [f"{ROOT}.ndom4.ex17.fast.npz",
                                     f"{ROOT}.ndom4.ex09.iters.npz"])
def test_iters(archives, archive, tmp_path, capsys):
    """Example 09's archive holds 0-d settings (nchains, nvec, ...) beside
    its (nchains, nsmp) tables: the curves are the tables alone."""
    d = np.load(archives / archive)
    assert any(d[k].ndim == 2 and d[k].dtype.kind == "i" for k in d.files)
    assert ("ex09" in archive) == any(d[k].ndim == 0 for k in d.files)
    out = tmp_path / "iters.png"
    postproc.main(["iters", str(archives / archive), str(out)])
    _png(out)
    assert f"wrote {out}" in capsys.readouterr().out


def test_field(archives, tmp_path):
    out = tmp_path / "field.png"
    postproc.main(["field", str(archives / f"{ROOT}.ex02.kl.npz"), str(out)])
    _png(out)


def test_partition(tmp_path):
    out = tmp_path / "partition.png"
    postproc.main(["partition", "400", "4", str(out)])
    _png(out)


def test_usage():
    with pytest.raises(SystemExit, match="Usage"):
        postproc.main([])
