"""Where a launch of kernel B goes, block by block, on one GPU.

    python3 krylov_spdes_tpu_torch/bench/sweep_phases.py [--sizes 500,1000]
        [--rows 1,2,3,4]

Builds a copy of csrc/fused_cg.cu into build/bench/ in which thread 0 of
every block reads %globaltimer at its entry, after step 0's barrier (its
first loads have arrived and its first direction rows are formed), after
its last row and after it has published its partial of d, and the last
block, which sums d, after d is written; the copy is generated from the
source, which stays as it is. Runs the
sweep on bench.py's system (krylov_spdes_tpu_torch/bench/sweep_bench.py,
float32, K = 5) through the port's own wrapper at each strip height, and
prints, in µs from the first block's entry, the quartiles and the maximum
of each stamp over the blocks, and when d was written.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from krylov_spdes_tpu_torch import fem  # noqa: E402
from krylov_spdes_tpu_torch.bench.sweep_bench import bench_system  # noqa: E402
from krylov_spdes_tpu_torch.ops import cuda_build, stencil  # noqa: E402
from krylov_spdes_tpu_torch.ops import fused_cg as fc  # noqa: E402

MAX_BLOCKS = 4096
SLOTS = 8
# (stamp, the line it goes before)
MARKS = [
    (0, "  const int strips = gridDim.y;\n"),
    (2, "  for (int i = 1; i < s.nr; ++i) {\n    cur = nxt;"),
    (3, "  // d: each block publishes"),
    (4, "  }\n  const int nb = gridDim.x * strips;\n"),
    (5, "    *d = b;\n"),
]
STAMPS = ["entry", "step 0 barrier", "step 0 done", "last row done",
          "partial published", "d written"]


def stamped_source():
    src = (ROOT / "krylov_spdes_tpu_torch/csrc/fused_cg.cu").read_text()
    csrc = ROOT / "krylov_spdes_tpu_torch/csrc"
    for h in ("common.cuh", "persistent.cuh"):
        src = src.replace(f'#include "{h}"', f'#include "{csrc}/{h}"')
    src = src.replace(
        "namespace {\n\n// ---- B",
        f"__device__ unsigned long long g_stamps[{MAX_BLOCKS * SLOTS}];\n"
        "#define STAMP(k) do { if (threadIdx.x == 0) g_stamps[(blockIdx.y * "
        f"gridDim.x + blockIdx.x) * {SLOTS} + (k)] = global_ns(); }} while (0)\n"
        "namespace {\n\n// ---- B", 1)
    for k, line in MARKS:
        assert src.count(line) == 1, line
        src = src.replace(line, f"  STAMP({k});\n" + line)
    line = "    __syncthreads();\n    if (!mine) return;\n"
    assert src.count(line) == 1
    src = src.replace(line, "    __syncthreads();\n    if (q == a) STAMP(1);\n"
                      "    if (!mine) return;\n")
    return src + ('\nextern "C" int read_stamps(void* host) {\n  return (int)'
                  'cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n')


def build():
    out = ROOT / "build/bench"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_cg_stamped.cu").write_text(stamped_source())
    lib = out / "libfused_cg_stamped.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "fused_cg_stamped.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.cg_sweep_limits.argtypes = [ci, ci, ci, vp]
    lib.cg_sweep.argtypes = [ci, ci] + [vp] * 8 + [ci] * 6 + [vp]
    lib.cg_sweep_limits.restype = lib.cg_sweep.restype = ci
    lib.error_string.argtypes = [ci]
    lib.error_string.restype = ctypes.c_char_p
    lib.read_stamps.argtypes = [vp]
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="500,1000")
    ap.add_argument("--rows", default="1,2,3,4")
    args = ap.parse_args()
    lib = build()
    fc._lib = lambda: lib            # the wrapper launches the stamped copy
    fc.sweep_limits.cache_clear()
    fc._sweep_plan_on.cache_clear()
    card = torch.cuda.get_device_name(0)
    for size in map(int, args.sizes.split(",")):
        ps, r, p, beta, _ = bench_system(size * size, fem, fc, stencil)
        pn0, ap0, _ = fc.cg_sweep_plain(ps, r, p, beta)
        for rows in map(int, args.rows.split(",")):
            plan = fc.sweep_plan_for(ps, r, rows=rows)
            nb = plan.segments * plan.strips   # the last one sums d
            assert nb <= MAX_BLOCKS
            for _ in range(3):
                pn, apv, _ = fc._sweep(ps, r, p, beta, plan)
            torch.cuda.synchronize()
            assert torch.equal(pn, pn0) and torch.equal(apv, ap0)
            st = np.zeros(MAX_BLOCKS * SLOTS, dtype=np.uint64)
            cuda_build.check(lib, lib.read_stamps(st.ctypes.data), "read_stamps")
            st = st.reshape(MAX_BLOCKS, SLOTS)[:nb, :len(STAMPS)].astype(np.int64)
            t0 = st[:, 0].min()
            rel = (st - t0) / 1e3
            out = {name: {"q25": float(np.percentile(rel[:, k], 25)),
                          "median": float(np.median(rel[:, k])),
                          "q75": float(np.percentile(rel[:, k], 75)),
                          "max": float(rel[:, k].max())}
                   for k, name in enumerate(STAMPS[:5])}
            out["d written"] = float(rel[nb - 1, 5])
            print(json.dumps(dict(kernel="B", H=ps.H, W=ps.W, rows=rows,
                                  blocks=nb, us_from_first_entry=out,
                                  card=card)), flush=True)


if __name__ == "__main__":
    main()
