"""Where an iteration of kernel E goes, phase by phase, on one GPU.

    python3 krylov_spdes_tpu_torch/bench/stretch_phases.py

Builds a copy of csrc/eigdef_stretch.cu into build/bench/ in which thread 0
of block 0 reads %globaltimer at the phase boundaries of every iteration
(the copy is generated from the source, which stays as it is), runs full
stretches on the 250k-node bench system at nvec 4 and 16 through the
port's own wrapper, and prints the mean µs of each phase over the middle
iterations. Block 0's view: a barrier's time includes waiting for the
slowest block.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from krylov_spdes_tpu_torch.bench.persistent_scaling import (  # noqa: E402
    bench_system, run_stretch, stretch_case)
from krylov_spdes_tpu_torch.ops import cuda_build  # noqa: E402
from krylov_spdes_tpu_torch.ops import fused_cg as fc  # noqa: E402
from krylov_spdes_tpu_torch.ops import vmem_eigdef as ve  # noqa: E402

# (stamp, the line it goes before); the phase between stamps k and k + 1 is
# PHASES[k]
MARKS = [
    "    // 1. ap = A·p, partial pᵀap",
    "    T ld = T(0);\n",
    "    T v1[1] = {ld};\n",
    "    bar.all_values(v1, sums, sh32, false);\n",
    "    const T alpha = rTz / sums[0];\n",
    "    // kRows rows of G at a time",
    "    if (threadIdx.x < nu) {\n      T v = shw[threadIdx.x];",
    "    bar.template warp_gather",
    "    // c_r = Acᵀ·U[:nvec]",
    "    // 3. one pass over W",
    "    T v2[2] = {lr, lz};",
    "    bar.all_values(v2, sums, sh32, false);",
    "    const T beta = rTz_new / rTz;",
    "    rTz = rTz_new;\n",
]
PHASES = ["halo rows + sync", "apply", "block sum", "all-gather pᵀap",
          "x, r", "U pass", "U partials + flag", "U gather", "c_r, c_p",
          "fix pass", "block sums", "all-gather rᵀr, rᵀz", "step 4",
          "neighbour wait"]


def stamped_source():
    src = (ROOT / "krylov_spdes_tpu_torch/csrc/eigdef_stretch.cu").read_text()
    csrc = ROOT / "krylov_spdes_tpu_torch/csrc"
    src = src.replace('#include "common.cuh"', f'#include "{csrc}/common.cuh"')
    src = src.replace('#include "persistent.cuh"',
                      f'#include "{csrc}/persistent.cuh"')
    src = src.replace(
        "namespace {\n\nconstexpr int kMaxU",
        "__device__ unsigned long long g_stamps[64 * 16];\n"
        "#define STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0 && "
        "it < 64) g_stamps[it * 16 + (k)] = global_ns(); } while (0)\n"
        "namespace {\n\nconstexpr int kMaxU", 1)
    for k, line in enumerate(MARKS):
        assert src.count(line) == 1, line
        src = src.replace(line, f"    STAMP({k});\n" + line)
    # the last stamp after the neighbour wait, with this iteration's `it`
    tail = "    ++it;\n    bar.neighbours();\n  }\n  __syncthreads();"
    assert src.count(tail) == 1
    src = src.replace(tail, "    bar.neighbours();\n    STAMP(14);\n    ++it;\n"
                      "  }\n  __syncthreads();")
    return src + ('\nextern "C" int read_stamps(void* host) {\n  return (int)'
                  'cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n')


def build():
    out = ROOT / "build/bench"
    out.mkdir(parents=True, exist_ok=True)
    (out / "eigdef_stretch_stamped.cu").write_text(stamped_source())
    lib = out / "libeigdef_stretch_stamped.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "eigdef_stretch_stamped.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.eigdef_stretch_limits.argtypes = [ci, ci, vp]
    lib.eigdef_stretch.argtypes = [ci, ci] + [vp] * 20 + [ci] * 11 + [vp]
    lib.error_string.argtypes = [ci]
    lib.error_string.restype = ctypes.c_char_p
    lib.read_stamps.argtypes = [vp]
    return lib


def main():
    lib = build()
    ve._lib = lambda: lib            # the wrapper launches the stamped copy
    card = torch.cuda.get_device_name(0)
    St, b = bench_system()
    ps = fc.build_padded_stencil(St)
    bp = fc.pad_vec(ps, b)
    minv = fc._jacobi_minv(ps, fc._unblock_planes(ps), None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for nvec in (4, 16):
        o = stretch_case(ps, minv, bp, St, nvec, gen)
        spdim = 2 * nvec + 33
        full = spdim - 1 - nvec
        V = bp.new_zeros((spdim, ps.R, ps.C))
        for _ in range(2):
            run_stretch(ps, minv, o, V, full, nvec)
            torch.cuda.synchronize()
        st = np.zeros(64 * 16, dtype=np.uint64)
        cuda_build.check(lib, lib.read_stamps(st.ctypes.data), "read_stamps")
        st = st.reshape(64, 16).astype(np.int64)[2:full - 1, :15]
        phases = np.diff(st, axis=1).mean(0) / 1e3
        print(json.dumps(dict(
            kernel="E", nvec=nvec,
            us_per_iteration=float((st[1:, 0] - st[:-1, 0]).mean() / 1e3),
            phases_us={n: float(v) for n, v in zip(PHASES, phases)},
            card=card)), flush=True)


if __name__ == "__main__":
    main()
