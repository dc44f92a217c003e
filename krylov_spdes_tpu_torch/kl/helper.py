"""KL DD helper: truncation presets + artifact naming.

Port of `krylov_spdes_tpu/kl/helper.py` (reference:
Fem/KarhunenLoeveDomainDecompositionHelper.jl:12-80).
"""

from __future__ import annotations


def suggest_parameters(nnode: int):
    """(relative_local, relative_global) presets validated by the reference
    up to 2M DoF / 500 subdomains
    (KarhunenLoeveDomainDecompositionHelper.jl:35-41, exact thresholds)."""
    if nnode <= 100_000:
        return 0.9986, 0.995
    return 0.9993, 0.995


def get_root_filename(model: str, sig2: float, L: float,
                      tentative_nnode: int) -> str:
    """Canonical artifact name `{Model}_sig2{σ²}_L{L}_DoF{n}`
    (KarhunenLoeveDomainDecompositionHelper.jl:72-80)."""
    return f"{model}_sig2{sig2}_L{L}_DoF{tentative_nnode}"
