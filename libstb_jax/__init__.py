"""libstb_jax -- Stirling-number & Pitman-Yor inference engine in JAX.

Re-architected capabilities of wbuntine/libstb for JAX/XLA on GPU
(see README.md and PARITY.md for the component map).

Public surface (lazy imports keep `import libstb_jax` light):

  core.stirling     S^n_{m,a} tables (make / remake / ensure; S/S1/U/V/UV)
  core.agrid        discount-grid tables (make_grid / ensure_grid)
  core.sapprox      closed-form approximations (m <= 4)
  core.special      digamma family, digamma_inv, logadd/logdiff
  core.lgcache      lgamma/digamma difference helpers
  core.sympoly      elementary symmetric polynomials + subset sampler
  core.ngg          NGG generalized Stirling tables + saddle points
  core.quadrature   tanh-sinh integrator
  samplers.slice    chain-parallel slice sampler
  samplers.ars      derivative-free ARS / ARMS
  samplers.hyper    sample_a / sample_a_m / sample_b
  models.pyp        CRP data gen + TI/CT/CTW/HSA Gibbs sweeps
  models.driver     run_gibbs (one cached jit program)
  models.hpyp       hierarchical PYP driver
  parallel.mesh     chain sharding, R-hat, ESS
  parallel.distributed  multi-host init
  native            C++ long-double oracle fill + CRP generator
  utils             checkpoint, metrics, config, yaps logging
"""
from __future__ import annotations

import importlib

__version__ = "0.1.0"

_SUBMODULES = (
    "core", "models", "samplers", "parallel", "native", "utils",
)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
