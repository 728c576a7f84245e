"""chip_smoke.py off the card: its device gate refuses a CPU-only run, and
each phase passes against its reference at small sizes on the CPU (the
script runs the same phases at full size on the GPU)."""
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

sys.path.pop(0)


def test_require_gpus_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(chip_smoke.SmokeError, match="GPU"):
        chip_smoke.require_gpus(1)


def test_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_check_raises_on_failure():
    chip_smoke.check("fine", 0.5, 1.0)
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.check("too big", 2.0, 1.0)
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.check("not finite", float("nan"), 1.0)


def test_phase_table_small():
    out = chip_smoke.phase_table(n=4096, m=64, ref_cols=16, block_n=512,
                                 queries=256)
    assert out["make_s"] > 0


def test_phase_grid_small():
    chip_smoke.phase_grid(n=1024, m=64, g=16, picks=(1, 7, 14), ref_cols=16)


def test_phase_gibbs_small():
    out = chip_smoke.phase_gibbs(n_groups=4, n_per_group=100, dim=10,
                                 chains=8, iters=6)
    assert 0.0 < out["a"] < 1.0


def test_phase_stat_small():
    worst = chip_smoke.phase_stat(chains=64, iters=60)
    assert set(worst) == {"T", "a", "b"}


def test_phase_hyper_small():
    out = chip_smoke.phase_hyper(chains=64, iters=4, curve_m=(128, 512),
                                 steps=2)
    assert out["samples_per_s"] > 0


def test_phase_multi_virtual():
    """The four-card phase on four of the suite's virtual CPU devices."""
    chip_smoke.phase_multi(4, grid_n=256, grid_m=32, grid_g=8)
