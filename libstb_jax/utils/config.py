"""Config system: dataclasses replacing the reference's three #define /
bitmask / getopt tiers (SURVEY.md §5.6).

* ``TableConfig``  -- the S_make bitmask flags (stable.h:25-44) plus the
  discount-grid parameters;
* ``SamplerConfig`` -- the compile-time sampler switches
  (PSAMPLE_ARS / SAMPLEA_M, psample.h:22-37) as runtime choices;
* helpers to build either from environment variables (``LIBSTB_*``) or an
  argparse namespace, so CLI programs share one schema.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["TableConfig", "SamplerConfig", "from_env"]


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """Per-table knobs (S_make flags analog).

    build_s / build_v  <-> S_STABLE | S_UVTABLE (stable.h:27-28)
    float32            <-> S_FLOAT  (stable.h:29; f64 only on CPU/x64)
    use_asympt         <-> S_ASYMPT (stable.h:41-44)
    quit_on_bound      <-> S_QUITONBOUND (stable.h:32-33): raise via
                           utils.yaps.quit instead of returning -inf --
                           a host-level policy the query layer applies
                           outside jit.
    verbose            <-> S_VERBOSE (stable.h:30-31)
    grid_points / a_lo / a_hi: the discount-grid replacement for
                           per-discount rebuilds (core/agrid.py).
    """
    init_n: int = 512
    init_m: int = 128
    max_n: int = 1 << 20
    max_m: int = 1 << 14
    build_s: bool = True
    build_v: bool = True
    float32: bool = True
    use_asympt: bool = True
    quit_on_bound: bool = False
    verbose: bool = False
    grid_points: int = 64
    a_lo: float = 0.0
    a_hi: float = 0.99


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampler algorithm switches (psample.h tiers as runtime config).

    kernel: "slice" (sslice.c analog, the default) or "ars"
            (PSAMPLE_ARS analog).
    loops:  burn-in loops inside one hyperparameter step (psample.h:100).
    b_shape/b_scale: concentration Gamma prior (demo.c:73-74 defaults).
    a_min/a_max/b_min/b_max: hard bounds (psample.h:54-59, 87-90).
    """
    kernel: str = "slice"
    loops: int = 1
    b_shape: float = 1.1
    b_scale: float = 20.0
    a_min: float = 0.01
    a_max: float = 0.98
    b_min: float = 0.01
    b_max: float = 2000.0


def _env(name: str, cast, default):
    v = os.environ.get(f"LIBSTB_{name.upper()}")
    if v is None:
        return default
    if cast is bool:
        return v.lower() in ("1", "true", "yes", "on")
    return cast(v)


def from_env(cls):
    """Build a TableConfig/SamplerConfig with LIBSTB_<FIELD> overrides."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        kwargs[f.name] = _env(f.name, type(f.default), f.default)
    return cls(**kwargs)
