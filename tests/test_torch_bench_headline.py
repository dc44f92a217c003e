"""PyTorch port, the root `bench.py`'s twin
(krylov_spdes_tpu_torch/bench/bench.py) on the CPU at small sizes.

Through `main(["--cpu"])` (float64): the device line, the JSON line under
the root bench.py's keys (read from the JAX file itself), no TPU pin in
`vs_baseline`, the certified fields as the JAX file gives them in
float64. Against the JAX package on the same numpy-seeded system: the
free-node nnz and the stencil equal, each scaled solve's `it` within ±2
of `_vmem_cg_call` in interpret mode on the same bₖ and tol² (the
symmetric K = 5 planes round their product-then-shift terms differently,
as tests/test_torch_fused_cg.py holds the two) and x within rtol 1e-6. The
certified solve in float32 on the CPU: ≤ 1e-7 by a float64 residual
computed apart from its certificate, its sweeps equal to the JAX
package's `refined_pcg` in float32 and its inner iterations within 5%
(float32 inner PCGs of two reduction orders; equal at this size). The DD
arm (a torch generator cannot continue a JAX key: held to itself): every
count below maxit, one step twice from the same state and W the same
`it`. A failure of kernel C or of the DD step raises, with no skip line;
without --cpu on a host with no card the twin raises."""

import ast
import contextlib
import dataclasses
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.ops import fused_cg as jfc
from krylov_spdes_tpu.ops import stencil as jst
from krylov_spdes_tpu.solvers.refine import refined_pcg as j_refined_pcg

from krylov_spdes_tpu_torch.bench import bench as tb
from krylov_spdes_tpu_torch.ops import fused_cg as tfc
from torch_bench_cases import ROOT, jax_json_keys, run_bench

torch.set_num_threads(1)
SIZES = dict(NNODE=2500, NSOLVE=2, DD_NNODE=2000, DD_NDOM=4, DD_NVEC=4)


@pytest.fixture(scope="module")
def headline():
    with pytest.MonkeyPatch.context() as mp:
        yield run_bench("bench", mp, **SIZES)


def test_module_imports_no_jax():
    with open(os.path.join(ROOT, "krylov_spdes_tpu_torch", "bench",
                           "bench.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert names and not [m for m in names if m.split(".")[0] in
                          ("jax", "jaxlib", "krylov_spdes_tpu")]


def test_json_line_is_bench_py_s(headline):
    r, lines, out = headline
    assert [list(d) for d in lines] == jax_json_keys("bench")
    d = lines[0]
    assert d["metric"] == "cg_spmv_throughput" and d["unit"] == "Gnnz/s"
    assert d["path"] == "vmem" and d["value"] > 0
    # the baselines default to the run's own values: no TPU pin
    assert d["vs_baseline"] == d["dd_chain_vs_baseline"] == 1.0
    # float64: no certified solve, as the JAX file on a float64 backend
    assert d["certified_relres_1e-7"] is None
    assert d["certified_iters"] == d["refine_sweeps"] == -1
    assert r["cert"] is None and "# certified:" not in out
    assert d["dd_chain_config"] == "2k/ndom4/nvec4/spdim12"
    assert d["dd_chain_ms_per_real"] == round(r["dd"]["ms"], 1) > 0
    assert d["value"] == pytest.approx(
        r["nnz"] * sum(r["its"]) / sorted(r["solve_ms"])[1] / 1e6, abs=1e-4)
    assert f"its={r['its']}" in out and "skipped" not in out


def _jax_system(nnode):
    """bench.py:50-64 in the JAX package (float64 on the CPU)."""
    mesh = get_mesh(nnode)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                    lambda x, y: -1.0 + 0.0 * x,
                                    lambda x, y: 0.0 * x)
    coeff = np.exp(0.3 * np.random.default_rng(0).normal(size=mesh.nnode))
    A, b = do_isotropic_elliptic_assembly(asm, coeff)
    m1 = int(round(np.sqrt(mesh.nnode)))
    St = jst.build_stencil_op(A, maps, (m1, m1))
    return St, jst.to_full_vector(maps, jnp.asarray(b), mesh.nnode), A.nnz


def test_scaled_solves_match_jax_vmem_cg(headline):
    r = headline[0]
    Sj, bj, nnz_j = _jax_system(SIZES["NNODE"])
    assert r["nnz"] == nnz_j
    np.testing.assert_allclose(r["St"].planes.numpy(), np.asarray(Sj.planes),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(r["b"].numpy(), np.asarray(bj), rtol=1e-13,
                               atol=1e-15)
    psj = jfc.build_padded_stencil(Sj)
    assert psj.K == r["ps"].K == 5
    pf = jfc._unblock_planes(psj)
    assert len(r["bks"]) == len(r["its"]) == SIZES["NSOLVE"]
    for bk, x, it in zip(r["bks"], r["xs"], r["its"]):
        bk_full = tfc.unpad_vec(r["ps"], bk)
        tol2 = float(r["rtol"] ** 2 * torch.sum(bk * bk))
        xj, itj, _ = jfc._vmem_cg_call(
            psj, pf, jfc.pad_vec(psj, jnp.asarray(bk_full.numpy())),
            r["maxit"], jnp.asarray(tol2), interpret=True)
        assert abs(it - int(itj)) <= 2, (it, int(itj))
        assert it < r["maxit"]
        np.testing.assert_allclose(tfc.unpad_vec(r["ps"], x).numpy(),
                                   np.asarray(jfc.unpad_vec(psj, xj)),
                                   rtol=1e-6, atol=1e-9)
    # the scales are linspace(1, 2): the solves differ by their b only
    np.testing.assert_allclose(r["bks"][-1].numpy(), 2 * r["bp"].numpy(),
                               rtol=1e-15)


def test_certified_float32_matches_jax():
    St, b, _ = tb.bench_system("cpu", torch.float32, SIZES["NNODE"])
    r = tb.certified(St, b)
    xh, xl = r.x_df32
    x64 = xh.double() + xl.double()
    St64 = dataclasses.replace(St, planes=St.planes.double(),
                               dir_diag=St.dir_diag.double())
    b64 = b.double()
    true_res = float(torch.linalg.vector_norm(b64 - St64.matvec(x64)) /
                     torch.linalg.vector_norm(b64))
    assert true_res <= 1e-7 and float(r.res_norm[0]) <= \
        1e-7 * float(torch.linalg.vector_norm(b))
    Sj = jst.StencilOp(planes=jnp.asarray(St.planes.numpy()),
                       dir_diag=jnp.asarray(St.dir_diag.numpy()),
                       slot=jnp.zeros((0,), jnp.int32), H=St.H, W=St.W)
    bj = jnp.asarray(b.numpy())
    rj = j_refined_pcg(Sj, bj, M=Partial(lambda d, v: d * v,
                                         1.0 / Sj.diagonal()),
                       rtol=1e-7, inner_rtol=1e-5, inner_maxit=tb.MAXIT)
    assert rj.x.dtype == jnp.float32
    assert r.refines == int(rj.refines)
    assert abs(int(r.it) - int(rj.it)) <= 0.05 * int(rj.it), (
        int(r.it), int(rj.it))


def test_dd_arm_below_maxit_and_repeatable(headline):
    dd = headline[0]["dd"]
    assert len(dd["its"]) == 10 and len(dd["step_ms"]) == 5
    assert 0 < min(dd["its"]) and max(dd["its"]) < dd["maxit"]

    def copy(s):
        gen = torch.Generator(device="cpu")
        gen.set_state(s.gen.get_state())
        return dataclasses.replace(s, gen=gen)
    its = [int(dd["step"](copy(dd["state"]), dd["W"])[2]) for _ in range(2)]
    assert its[0] == its[1] < dd["maxit"]


def _raise(*a, **k):
    raise RuntimeError("injected failure")


@pytest.mark.parametrize("where", ["kernel_c", "dd_step"])
def test_no_fallback(where, monkeypatch):
    """A failure of kernel C or of the DD step raises out of main; nothing
    prints a skip line or reruns another path."""
    if where == "kernel_c":
        monkeypatch.setattr(tfc, "whole_cg", _raise)
    else:
        import krylov_spdes_tpu_torch.dd_chains as tdc
        monkeypatch.setattr(tdc, "make_dd_chain_step", _raise)
    for k, v in SIZES.items():
        monkeypatch.setenv(f"BENCH_{k}", str(v))
    buf = io.StringIO()
    with pytest.raises(RuntimeError, match="injected failure"):
        with contextlib.redirect_stdout(buf):
            tb.main(["--cpu"])
    out = buf.getvalue()
    assert "skipped" not in out and "{" not in out
    assert ("# cg_spmv:" in out) == (where == "dd_step")


def test_main_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main([]) runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with contextlib.redirect_stdout(io.StringIO()):
            tb.main([])
