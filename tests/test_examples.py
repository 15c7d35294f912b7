"""Examples double as smoke tests — the analog of each reference example's
``test_main`` (/root/reference/examples/*.rs)."""

import importlib.util
import os

import pytest

_EXAMPLES_DIR = os.path.join(os.path.dirname(__file__), "..", "examples")


def _run_example(name):
    path = os.path.join(_EXAMPLES_DIR, name + ".py")
    spec = importlib.util.spec_from_file_location(f"examples.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


@pytest.mark.parametrize(
    "name",
    [
        "minimal_mh",
        "gauss_mh",
        "rosenbrock_mh",
        "poisson_mh",
        "minimal_hmc",
        "rosenbrock3d_hmc",
        "minimal_nuts",
        "mixture_gibbs",
        "logistic_regression_nuts",
        "metric_nuts",
        "eight_schools_nuts",
        "ensemble_walkers",
        "chees_trajectory_adaptation",
        "bimodal_tempering",
        "ais_log_z",
        "gp_robust_regression",
        "streaming_production_run",
        "sharded_chains",
        "sgld_minibatch_logreg",
        "sgld_data_parallel",
        "constrained_transforms",
        "bigd_separable_hmc",
    ],
)
def test_example(name):
    _run_example(name)


def test_eight_schools_dc_forms_match_autodiff():
    """The hand-written chains-on-lanes logp_dc/grad_dc of the 8-schools
    non-centered target must agree with
    logp_batch and its autodiff gradient."""
    import importlib.util
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "es8", os.path.join(os.path.dirname(__file__), "..",
                            "examples", "eight_schools_nuts.py"))
    es8 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(es8)
    t = es8.make_noncentered_target()

    key = jax.random.PRNGKey(0)
    pos = jax.random.normal(key, (16, 10), jnp.float32)
    pos = pos.at[:, 1].set(0.3 * pos[:, 1])  # keep tau sane

    lp_dc = np.asarray(t.logp_dc(pos.T))
    lp_batch = np.asarray(t.logp_batch(pos))
    np.testing.assert_allclose(lp_dc, lp_batch, rtol=2e-6, atol=2e-5)

    g_dc = np.asarray(t.grad_dc(pos.T)).T
    g_auto = np.asarray(jax.vmap(jax.grad(t.logp))(pos))
    np.testing.assert_allclose(g_dc, g_auto, rtol=2e-5, atol=2e-5)

    # and the [D, 8, C/8] kernel layout broadcasts identically
    p3 = pos.T.reshape(10, 8, 2)
    np.testing.assert_allclose(
        np.asarray(t.logp_dc(p3)).reshape(-1), lp_batch, rtol=2e-6,
        atol=2e-5)
