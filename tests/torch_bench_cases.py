"""Helpers of the tests of the port's measurement drivers
(krylov_spdes_tpu_torch/bench/): the JSON keys of a root JAX file, and a
twin's `main(["--cpu"])` run with its BENCH_* variables set."""

import ast
import contextlib
import importlib
import io
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_json_keys(name):
    """The key lists of the dict literals the root JAX file passes to
    json.dumps, in the order of the calls."""
    with open(os.path.join(ROOT, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    return [[k.value for k in node.args[0].keys]
            for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "")
            == "dumps" and node.args and isinstance(node.args[0], ast.Dict)]


def run_bench(name, monkeypatch, **env):
    """The port's bench driver on the CPU with the BENCH_* variables of
    `env`: (its result, its JSON lines, its output)."""
    for k, v in env.items():
        monkeypatch.setenv(f"BENCH_{k}", str(v))
    mod = importlib.import_module(f"krylov_spdes_tpu_torch.bench.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = mod.main(["--cpu"])
    out = buf.getvalue()
    assert out.splitlines()[0] == "device cpu float64"
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    return result, lines, out
