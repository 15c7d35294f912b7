"""Distribution golden-value tests.

Mirrors the reference's in-module numeric tests
(/root/reference/src/distributions.rs:572-831): normalized Gaussian log
densities against hand-computed constants, categorical sampling frequencies
vs the pmf, Rosenbrock values and gradients vs finite differences.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mini_mcmc_tpu.models import (
    Categorical,
    binomial_target,
    diffable_gaussian2d,
    gaussian2d,
    isotropic_gaussian_proposal,
    isotropic_gaussian_target,
    poisson_target,
    rosenbrock2d,
    rosenbrock_nd,
)


def test_gaussian2d_normalized_logp_standard():
    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    # standard bivariate normal at origin: -ln(2 pi)
    lp = target.logp_normalized(jnp.array([0.0, 0.0]))
    assert np.isclose(float(lp), -np.log(2 * np.pi), atol=1e-6)
    # at (1, 0): -ln(2 pi) - 0.5
    lp = target.logp_normalized(jnp.array([1.0, 0.0]))
    assert np.isclose(float(lp), -np.log(2 * np.pi) - 0.5, atol=1e-6)


def test_gaussian2d_unnorm_logp_correlated():
    cov = np.array([[2.0, 0.5], [0.5, 1.0]])
    target = gaussian2d([1.0, -1.0], cov)
    x = np.array([0.3, 0.7])
    diff = x - np.array([1.0, -1.0])
    expected = -0.5 * diff @ np.linalg.inv(cov) @ diff
    assert np.isclose(float(target.logp(jnp.asarray(x))), expected, atol=1e-6)


def test_gaussian_targets_construct_under_trace():
    # Building the targets with TRACED mean/cov (e.g. a jitted
    # hyperparameter sweep) must work: the Pallas-only _dc forms are
    # dropped (they need Python-float coefficients) but every XLA path
    # stays usable.
    @jax.jit
    def logp_at_origin(mean):
        cov = jnp.eye(2)
        t1 = gaussian2d(mean, cov)
        t2 = diffable_gaussian2d(mean, cov)
        assert t1.logp_dc is None and t2.logp_dc is None
        x = jnp.zeros(2)
        return t1.logp(x) + t2.logp(x) + t2.grad(x)[0]

    val = logp_at_origin(jnp.array([1.0, 0.0]))
    expected = -0.5 + (-np.log(2 * np.pi) - 0.5) + 1.0
    assert np.isclose(float(val), expected, atol=1e-6)


def test_diffable_gaussian2d_matches_scipy_logpdf():
    cov = np.array([[4.0, 2.0], [2.0, 3.0]])
    mean = np.array([0.0, 1.0])
    target = diffable_gaussian2d(mean, cov)
    x = np.array([0.5, 2.0])
    diff = x - mean
    expected = (
        -np.log(2 * np.pi)
        - 0.5 * np.log(np.linalg.det(cov))
        - 0.5 * diff @ np.linalg.inv(cov) @ diff
    )
    assert np.isclose(float(target.logp(jnp.asarray(x))), expected, atol=1e-6)
    # batched form agrees
    batch = jnp.asarray(np.stack([x, mean]))
    vals = target.batch_logp(batch)
    assert np.isclose(float(vals[0]), expected, atol=1e-6)
    # analytic gradient matches AD
    g_analytic = target.grad(jnp.asarray(x))
    g_ad = jax.grad(target.logp)(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(g_analytic), np.asarray(g_ad), atol=1e-6)


def test_isotropic_gaussian_target_logp():
    target = isotropic_gaussian_target(2.0)
    x = jnp.array([1.0, 2.0, 3.0])
    expected = -0.5 * (1 + 4 + 9) / 4.0
    assert np.isclose(float(target.logp(x)), expected, atol=1e-6)


def test_isotropic_proposal_symmetric_logq():
    # The reference's normalization quirk is preserved
    # (distributions.rs:379-386); symmetry is what MH relies on.
    prop = isotropic_gaussian_proposal(1.5)
    a = jnp.array([0.0, 1.0])
    b = jnp.array([2.0, -1.0])
    assert np.isclose(float(prop.logp(a, b)), float(prop.logp(b, a)), atol=1e-7)
    var = 1.5**2
    expected = -np.sum((np.array([2.0, -2.0])) ** 2) / (2 * var) - 2 * 0.5 * np.log(
        var * np.pi * var
    )
    assert np.isclose(float(prop.logp(a, b)), expected, atol=1e-5)


def test_isotropic_proposal_sample_distribution():
    prop = isotropic_gaussian_proposal(1.0)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 20000)
    current = jnp.zeros(2)
    samples = jax.vmap(lambda k: prop.sample(k, current))(keys)
    assert abs(float(jnp.mean(samples))) < 0.03
    assert abs(float(jnp.std(samples)) - 1.0) < 0.03


def test_categorical_normalizes_and_samples():
    # Frequencies vs pmf at 100k draws within 1-2%
    # (distributions.rs:667-762).
    cat = Categorical([2.0, 3.0, 5.0])
    np.testing.assert_allclose(np.asarray(cat.probs), [0.2, 0.3, 0.5], atol=1e-7)
    draws = cat.sample(jax.random.PRNGKey(1), (100_000,))
    freqs = np.bincount(np.asarray(draws), minlength=3) / 100_000
    np.testing.assert_allclose(freqs, [0.2, 0.3, 0.5], atol=0.02)
    assert np.isclose(float(cat.logp(1)), np.log(0.3), atol=1e-6)
    assert float(cat.logp(7)) == -np.inf
    assert float(cat.logp(-1)) == -np.inf


def test_rosenbrock2d_logp_and_grad():
    target = rosenbrock2d(1.0, 100.0)
    x = jnp.array([0.5, 1.5])
    expected = -((1.0 - 0.5) ** 2 + 100.0 * (1.5 - 0.25) ** 2)
    assert np.isclose(float(target.logp(x)), expected, atol=1e-5)
    g_analytic = target.grad(x)
    g_ad = jax.grad(target.logp)(x)
    np.testing.assert_allclose(np.asarray(g_analytic), np.asarray(g_ad), rtol=1e-6)


def test_rosenbrock_nd_matches_reference_form():
    target = rosenbrock_nd()
    x = jnp.array([0.5, 1.5, 2.0])
    expected = -(
        100.0 * (1.5 - 0.25) ** 2
        + (1 - 0.5) ** 2
        + 100.0 * (2.0 - 2.25) ** 2
        + (1 - 1.5) ** 2
    )
    assert np.isclose(float(target.logp(x)), expected, atol=1e-5)
    g_analytic = target.grad(x)
    g_ad = jax.grad(target.logp)(x)
    np.testing.assert_allclose(np.asarray(g_analytic), np.asarray(g_ad), rtol=1e-6)
    # batched agrees with vmap
    batch = jnp.stack([x, x * 0.5])
    np.testing.assert_allclose(
        np.asarray(target.logp_batch(batch)),
        np.asarray(jax.vmap(target.logp)(batch)),
        rtol=1e-6,
    )


def test_poisson_target_logp():
    target = poisson_target(4.0)
    lp3 = float(target.logp(jnp.array([3], jnp.int32)))
    expected = 3 * np.log(4.0) - 4.0 - np.log(6.0)
    assert np.isclose(lp3, expected, atol=1e-5)
    assert float(target.logp(jnp.array([-1], jnp.int32))) == -np.inf


def test_binomial_target_logp():
    target = binomial_target(10, 0.3)
    from scipy.stats import binom

    for k in [0, 3, 10]:
        lp = float(target.logp(jnp.array([k], jnp.int32)))
        assert np.isclose(lp, binom.logpmf(k, 10, 0.3), atol=1e-5)
    assert float(target.logp(jnp.array([11], jnp.int32))) == -np.inf


def test_gaussian_random_walk_proposal():
    from mini_mcmc_tpu.models import gaussian_random_walk_proposal

    prop = gaussian_random_walk_proposal([0.5, 2.0])
    a = jnp.array([0.0, 0.0])
    b = jnp.array([0.5, 2.0])
    # symmetric in (from, to)
    assert np.isclose(float(prop.logp(a, b)), float(prop.logp(b, a)), atol=1e-7)
    # correct normalized diagonal-Gaussian density: one-sigma displacement
    expected = (
        -0.5 * 2.0
        - np.log(0.5) - np.log(2.0)
        - np.log(2 * np.pi)
    )
    assert np.isclose(float(prop.logp(a, b)), expected, atol=1e-5)
    # per-dim scales respected in samples
    keys = jax.random.split(jax.random.PRNGKey(0), 20000)
    draws = jax.vmap(lambda k: prop.sample(k, a))(keys)
    np.testing.assert_allclose(
        np.asarray(jnp.std(draws, axis=0)), [0.5, 2.0], rtol=0.05
    )


def test_samplers_reject_1d_initial_positions():
    import pytest

    from mini_mcmc_tpu import NUTS, MetropolisHastings
    from mini_mcmc_tpu.models import isotropic_gaussian_proposal

    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    with pytest.raises(ValueError, match="n_chains, dim"):
        MetropolisHastings(
            target, isotropic_gaussian_proposal(1.0), jnp.zeros(2)
        )
    with pytest.raises(ValueError, match="n_chains, dim"):
        NUTS(target, jnp.zeros(2))


def test_neal_funnel_logp_and_grad():
    from mini_mcmc_tpu.models import neal_funnel

    t = neal_funnel(3.0)
    x = jnp.array([0.5, 1.0, -2.0])
    # hand-computed: -0.5*v^2/9 - 0.5*(1+4)*e^-v - 0.5*2*v
    expected = -0.5 * 0.25 / 9.0 - 0.5 * 5.0 * np.exp(-0.5) - 0.5
    assert np.isclose(float(t.logp(x)), expected, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(t.grad(x)), np.asarray(jax.grad(t.logp)(x)), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(t.logp_batch(jnp.stack([x, x * 0.3]))),
        np.asarray(jax.vmap(t.logp)(jnp.stack([x, x * 0.3]))),
        rtol=1e-6,
    )


def test_poisson_target_with_traced_lam_drops_dc_form():
    # built under jit/vmap over hyperparameters, the dc-form coefficients
    # can't be baked in: construction must still succeed with logp_dc=None
    # (Target.dc_forms then derives it), and the batch path must work
    import jax

    from mini_mcmc_tpu.models import poisson_target

    def build_logp(lam, k):
        t = poisson_target(lam)
        assert t.logp_dc is None
        return t.logp(k)

    out = jax.jit(build_logp)(4.0, jnp.array([3], jnp.int32))
    ref = poisson_target(4.0).logp(jnp.array([3], jnp.int32))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6)
    assert poisson_target(4.0).logp_dc is not None


# -- chains-on-lanes (dc) forms ------------------------------------------------


def test_dc_forms_match_batch_forms():
    target = rosenbrock_nd()
    x = jax.random.normal(jax.random.PRNGKey(0), (16, 4), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(target.logp_dc(x.T)),
        np.asarray(target.logp_batch(x)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(target.grad_dc(x.T).T),
        np.asarray(jax.vmap(target.grad)(x)),
        rtol=1e-6,
    )


def test_derive_grad_dc_matches_handwritten():
    """AD-derived chains-on-lanes gradient == hand-written, on both the
    [D, C] layout and a [D, C1, C2] multi-axis lane layout."""
    import dataclasses

    from mini_mcmc_tpu.models.base import derive_grad_dc

    target = rosenbrock_nd()
    x = jax.random.normal(jax.random.PRNGKey(1), (16, 4), jnp.float32)
    derived = derive_grad_dc(target.logp_dc)
    np.testing.assert_allclose(np.asarray(derived(x.T)),
                               np.asarray(target.grad_dc(x.T)),
                               rtol=1e-5, atol=1e-6)
    p3 = x.T.reshape(4, 8, 2)
    np.testing.assert_allclose(np.asarray(derived(p3)),
                               np.asarray(target.grad_dc(p3)),
                               rtol=1e-5, atol=1e-6)

    # dc_forms(): pass-through when grad_dc exists, derivation when not.
    lp, g = target.dc_forms()
    assert g is target.grad_dc
    stripped = dataclasses.replace(target, grad_dc=None)
    lp2, g2 = stripped.dc_forms()
    assert lp2 is target.logp_dc and g2 is not None
    np.testing.assert_allclose(np.asarray(g2(x.T)),
                               np.asarray(target.grad_dc(x.T)),
                               rtol=1e-5, atol=1e-6)


def test_derive_logp_dc_lane_shapes():
    """derive_logp_dc handles both the [D, C] layout and a multi-axis
    [D, C1, C2] lane layout (moveaxis/reshape round-trip)."""
    from mini_mcmc_tpu.models.base import derive_logp_dc

    target = rosenbrock_nd()
    x = jax.random.normal(jax.random.PRNGKey(2), (16, 4), jnp.float32)
    derived = derive_logp_dc(target.batch_logp)
    np.testing.assert_allclose(np.asarray(derived(x.T)),
                               np.asarray(target.batch_logp(x)),
                               rtol=1e-6)
    p3 = x.T.reshape(4, 8, 2)
    np.testing.assert_allclose(np.asarray(derived(p3)),
                               np.asarray(target.logp_dc(p3)),
                               rtol=1e-5, atol=1e-6)


def test_neal_funnel_dc_form():
    """The funnel's dc form matches its batch form, and the gradient
    derived from it matches the analytic one."""
    from mini_mcmc_tpu.models import neal_funnel

    t = neal_funnel()
    x = jax.random.normal(jax.random.PRNGKey(3), (16, 5), jnp.float32)
    np.testing.assert_allclose(np.asarray(t.logp_dc(x.T)),
                               np.asarray(t.logp_batch(x)),
                               rtol=1e-5, atol=1e-5)
    _, g_derived = t.dc_forms()
    np.testing.assert_allclose(np.asarray(g_derived(x.T).T),
                               np.asarray(jax.vmap(t.grad)(x)),
                               rtol=1e-5, atol=1e-5)


def test_eight_schools_example_dc_forms_validate():
    """The hierarchical D=10 example's hand-written dc forms agree with its
    batch forms (value and gradient) on random positions."""
    import importlib.util
    import os

    from mini_mcmc_tpu.models.base import validate_dc_forms

    spec = importlib.util.spec_from_file_location(
        "es8", os.path.join(os.path.dirname(__file__), "..",
                            "examples", "eight_schools_nuts.py"))
    es8 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(es8)
    target = es8.make_noncentered_target()
    assert target.logp_dc is not None
    pos = 0.5 * jax.random.normal(jax.random.PRNGKey(5), (64, 10),
                                  jnp.float32)
    validate_dc_forms(target, pos)


def _gaussian_with_dc():
    return gaussian2d([0.0, 0.0], [[2.0, 0.5], [0.5, 1.0]])


def _lane_coupled(logp_dc):
    """A logp_dc whose VALUES are right but which couples lanes through a
    reduction: the ratio is 1 numerically, but the VJP picks up a
    sum-over-lanes term, corrupting the AD-derived gradient."""

    def sneaky(p, _f=logp_dc):
        lp = _f(p)
        total = jnp.sum(lp)
        return lp * (total / jax.lax.stop_gradient(total))

    return sneaky


def test_corrupted_logp_dc_fails_construction():
    """A hand-written logp_dc that disagrees with logp (a dropped-term
    scale: the class of bug that still 'samples something plausible')
    is rejected by validate_dc_forms; the good form passes."""
    import dataclasses

    import pytest

    from mini_mcmc_tpu import init_det
    from mini_mcmc_tpu.models.base import validate_dc_forms

    good = _gaussian_with_dc()
    bad = dataclasses.replace(
        good, logp_dc=lambda p, _f=good.logp_dc: 0.9 * _f(p)
    )
    pos = init_det(16, 2)
    with pytest.raises(ValueError, match="disagrees"):
        validate_dc_forms(bad, pos)
    with pytest.raises(ValueError, match="disagrees"):
        validate_dc_forms(bad, pos, need_grad=False)
    validate_dc_forms(good, pos)


def test_corrupted_grad_dc_fails_construction():
    import dataclasses

    import pytest

    from mini_mcmc_tpu import init_det
    from mini_mcmc_tpu.models.base import validate_dc_forms

    target = rosenbrock_nd()
    bad = dataclasses.replace(
        target, grad_dc=lambda p, _f=target.grad_dc: -_f(p)  # wrong sign
    )
    with pytest.raises(ValueError, match="grad_dc"):
        validate_dc_forms(bad, init_det(8, 3))


def test_cross_lane_reduction_logp_dc_caught_by_grad_probe():
    """A value-correct logp_dc that couples lanes corrupts the AD-derived
    gradient silently; the validator catches it via the gradient check."""
    import dataclasses

    import pytest

    from mini_mcmc_tpu import init_det
    from mini_mcmc_tpu.models.base import validate_dc_forms

    target = rosenbrock_nd()
    bad = dataclasses.replace(target, logp_dc=_lane_coupled(target.logp_dc),
                              grad_dc=None)
    with pytest.raises(ValueError, match="grad_dc"):
        validate_dc_forms(bad, init_det(8, 3))


def test_handwritten_grad_dc_without_logp_dc_checked():
    """A corrupted hand-written grad_dc supplied WITHOUT a logp_dc is
    still rejected: dc_forms() hands the hand-written gradient on even
    when logp_dc derives, so the validator cannot early-return on
    logp_dc-is-None alone."""
    import dataclasses

    import pytest

    from mini_mcmc_tpu import init_det
    from mini_mcmc_tpu.models.base import validate_dc_forms

    target = rosenbrock_nd()
    bad = dataclasses.replace(
        target, logp_dc=None,
        grad_dc=lambda p, _f=target.grad_dc: -_f(p),  # wrong sign
    )
    with pytest.raises(ValueError, match="grad_dc"):
        validate_dc_forms(bad, init_det(8, 3))


def test_gradient_free_fused_samplers_skip_derived_grad_probe():
    """need_grad=False (value-only consumers) skips the derived-gradient
    probe: a value-correct, lane-coupled logp_dc passes there and is
    still rejected when the gradient is needed."""
    import dataclasses

    import pytest

    from mini_mcmc_tpu import init_det
    from mini_mcmc_tpu.models.base import validate_dc_forms

    target = _gaussian_with_dc()
    bad = dataclasses.replace(target, logp_dc=_lane_coupled(target.logp_dc),
                              grad_dc=None)
    pos = init_det(16, 2)
    validate_dc_forms(bad, pos, need_grad=False)
    with pytest.raises(ValueError, match="grad_dc"):
        validate_dc_forms(bad, pos)
