"""``chip_smoke.py`` on the CPU: every phase at toy size, the refusal
without a GPU, the compile-cache placement and the result line.

The phases take their sizes as arguments; here they run the same code and
the same gates as on the card, at sizes small enough for the CPU.
"""

import json
import os
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

PHASES = {
    "hmc_flagship": (chip_smoke.phase_hmc_flagship,
                     dict(n_chains=256, n_draws=256)),
    "nuts": (chip_smoke.phase_nuts,
             dict(n_chains=512, n_collect=256, n_discard=64)),
    "mh_gauss2d": (chip_smoke.phase_mh_gauss,
                   dict(n_chains=1024, n_draws=512)),
    "mh_poisson": (chip_smoke.phase_mh_poisson, dict(n_chains=1024)),
    "gibbs_mixture": (chip_smoke.phase_gibbs,
                      dict(n_chains=512, n_draws=2048)),
    "tempering_bimodal": (chip_smoke.phase_tempering,
                          dict(n_chains=512, n_draws=1024)),
    "hmc_d10000": (chip_smoke.phase_hmc_bigd,
                   dict(n_chains=64, dim=256, n_draws=128, n_diag=64)),
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_single_card_phase_gates_pass_at_toy_size(name):
    phase, sizes = PHASES[name]
    metrics = phase(**sizes)
    assert metrics["steady_s"] > 0.0
    assert metrics["draws_per_s"] > 0.0
    assert metrics["compile_s"] >= 0.0


def test_every_single_card_phase_is_covered():
    assert {name for name, _ in chip_smoke.SINGLE_PHASES} == set(PHASES)


def test_reference_phase_runs_every_comparison():
    cpu = jax.devices("cpu")
    errs = chip_smoke.phase_reference(
        cpu[0], cpu[1], flagship=(256, 3), wide=(16, 512), dense=(64, 16))
    assert set(errs) == {
        "logp_flagship", "grad_flagship", "logp_wide", "grad_wide",
        "leapfrog_L8", "dense_metric_logp", "dense_metric_grad",
        "prior_draw", "default_precision_to_x",
    }
    # the same code on two CPU devices: identical arithmetic
    assert max(errs.values()) == 0.0


def test_multi_phase_on_four_virtual_devices():
    metrics = chip_smoke.phase_multi(jax.devices()[:4], n_chains=256,
                                     n_draws=32, n_leapfrog=16)
    assert metrics["n_devices"] == 4
    assert metrics["chains_per_card"] == 64
    assert metrics["frac_chains_within_1e-4"] >= 0.999


def test_main_refuses_a_machine_without_gpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_contract(count):
    devices = jax.devices()[:count]
    line = json.loads(chip_smoke.result_line(devices))
    assert line == {"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": count,
    }}


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, tmp_path, monkeypatch,
                                 restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert chip_smoke.configure_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; nothing else is set in code
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(chip_smoke.REPO, ".jax_cache")
        assert chip_smoke.configure_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
