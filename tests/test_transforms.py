"""Constrained-parameter transform layer (models/transforms.py).

The reference never needs constraints (all its targets are unconstrained,
/root/reference/src/distributions.rs); the transform layer is the
beyond-reference machinery that makes positivity/interval constraints
first-class instead of the hand-rolled ``exp`` reparameterization in
examples/eight_schools_nuts.py — which doubles as the exact functional pin
here: the transformed CENTERED eight-schools density must equal the
example's hand-written log_tau form identically.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_mcmc_tpu import HMC, NUTS, ParallelTempering, init_det, init_with_seed
from mini_mcmc_tpu.models import (
    CoordinateTransform,
    interval,
    lower_bounded,
    positive,
    transformed_target,
    upper_bounded,
)
from mini_mcmc_tpu.models.base import Target, validate_dc_forms


def _load_es8():
    spec = importlib.util.spec_from_file_location(
        "es8_tf", os.path.join(os.path.dirname(__file__), "..",
                               "examples", "eight_schools_nuts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bijector_roundtrips_and_log_det_matches_ad():
    y = jnp.linspace(-3.0, 3.0, 41)
    for bij in (positive(), lower_bounded(-2.0), upper_bounded(5.0),
                interval(-1.0, 3.0)):
        x = bij.forward(y)
        np.testing.assert_allclose(np.asarray(bij.inverse(x)),
                                   np.asarray(y), rtol=1e-5, atol=1e-5)
        # log|dx/dy| against AD of the forward map
        d = jax.vmap(jax.grad(lambda s: bij.forward(s)))(y)
        np.testing.assert_allclose(np.asarray(bij.log_det(y)),
                                   np.log(np.abs(np.asarray(d))),
                                   rtol=1e-5, atol=1e-5)


def test_interval_validates_bounds():
    with pytest.raises(ValueError, match="high > low"):
        interval(2.0, 2.0)


def test_coordinate_transform_maps_and_masks():
    tf = CoordinateTransform({0: positive(), 2: interval(0.0, 1.0)}, dim=3)
    y = jnp.array([[0.5, -1.2, 0.3], [-0.4, 2.0, -2.0]])
    x = tf.to_x(y)
    np.testing.assert_allclose(np.asarray(x[:, 0]),
                               np.exp(np.asarray(y[:, 0])), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(x[:, 1]), np.asarray(y[:, 1]))
    assert np.all((np.asarray(x[:, 2]) > 0) & (np.asarray(x[:, 2]) < 1))
    # inverse round-trip through the masked application
    np.testing.assert_allclose(np.asarray(tf.to_y(x)), np.asarray(y),
                               rtol=1e-5, atol=1e-6)
    # log_det = sum of the constrained coordinates' terms only
    expect = np.asarray(y[:, 0]) + np.asarray(
        interval(0.0, 1.0).log_det(y[:, 2]))
    np.testing.assert_allclose(np.asarray(tf.log_det(y)), expect, rtol=1e-5)

    with pytest.raises(ValueError, match="dim is required"):
        CoordinateTransform({0: positive()})
    with pytest.raises(ValueError, match="out of range"):
        CoordinateTransform({5: positive()}, dim=3)


def test_wrap_matches_manual_change_of_variables():
    """Exponential(1) through positive(): logp_y = -exp(y) + y, and the
    wrapped analytic gradient equals AD."""
    target_x = Target(logp=lambda x: -x[0], grad=lambda x: -jnp.ones_like(x))
    wrapped, tf = transformed_target(target_x, [positive()])
    y = jnp.array([0.7])
    np.testing.assert_allclose(float(wrapped.logp(y)),
                               float(-jnp.exp(y[0]) + y[0]), rtol=1e-6)
    g_ad = jax.grad(lambda v: -jnp.exp(v[0]) + v[0])(y)
    np.testing.assert_allclose(np.asarray(wrapped.grad(y)),
                               np.asarray(g_ad), rtol=1e-6)
    # batch form agrees with vmap of logp
    ys = jnp.linspace(-1.0, 1.0, 8)[:, None]
    np.testing.assert_allclose(np.asarray(wrapped.batch_logp(ys)),
                               np.asarray(jax.vmap(wrapped.logp)(ys)),
                               rtol=1e-6)


def test_transformed_centered_eight_schools_equals_handwritten():
    """The example's centered target hand-rolls tau = exp(log_tau) with the
    +log_tau Jacobian; building the same model in NATURAL (tau > 0)
    coordinates and wrapping coordinate 1 with positive() must reproduce
    that density IDENTICALLY — the 'stop hand-rolling exp' contract."""
    es8 = _load_es8()
    y_obs, sig = jnp.asarray(es8.Y), jnp.asarray(es8.SIGMA)

    def logp_natural(params):  # [C, 10] with tau = params[:, 1] > 0
        mu, tau, theta = params[:, :1], params[:, 1:2], params[:, 2:]
        loglik = -0.5 * jnp.sum(((y_obs - theta) / sig) ** 2, axis=1)
        logp_theta = (-0.5 * jnp.sum(((theta - mu) / tau) ** 2, axis=1)
                      - 8.0 * jnp.log(tau[:, 0]))
        logp_mu = -0.5 * (mu[:, 0] / es8.MU_PRIOR_STD) ** 2
        return (loglik + logp_theta + logp_mu
                + es8._log_half_cauchy(tau[:, 0]))

    natural = Target(logp=lambda p: logp_natural(p[None, :])[0],
                     logp_batch=logp_natural)
    wrapped, _tf = transformed_target(natural, {1: positive()}, dim=10)
    hand = es8.make_centered_target()

    ys = 0.5 * jax.random.normal(jax.random.PRNGKey(0), (64, 10))
    np.testing.assert_allclose(np.asarray(wrapped.batch_logp(ys)),
                               np.asarray(hand.batch_logp(ys)),
                               rtol=1e-5, atol=1e-5)
    # ...and the gradients (AD through the transform vs AD through the
    # hand-written log-space density)
    _, g_w = wrapped.batch_logp_and_grad(ys)
    _, g_h = hand.batch_logp_and_grad(ys)
    np.testing.assert_allclose(np.asarray(g_w), np.asarray(g_h),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_transformed_noncentered_eight_schools_recovers_exact_moments():
    """End-to-end: the non-centered model written in NATURAL tau > 0
    coordinates + positive() transform, sampled with NUTS, recovers the
    quadrature-exact posterior means (the example's gate, via the
    transform layer instead of the hand-rolled log_tau)."""
    es8 = _load_es8()
    y_obs, sig = jnp.asarray(es8.Y), jnp.asarray(es8.SIGMA)

    def logp_natural(params):  # [C, 10]: [mu, tau>0, eta_1..8]
        mu, tau, eta = params[:, :1], params[:, 1:2], params[:, 2:]
        theta = mu + tau * eta
        loglik = -0.5 * jnp.sum(((y_obs - theta) / sig) ** 2, axis=1)
        logp_eta = -0.5 * jnp.sum(eta * eta, axis=1)
        logp_mu = -0.5 * (mu[:, 0] / es8.MU_PRIOR_STD) ** 2
        return (loglik + logp_eta + logp_mu
                + es8._log_half_cauchy(tau[:, 0]))

    natural = Target(logp=lambda p: logp_natural(p[None, :])[0],
                     logp_batch=logp_natural)
    wrapped, tf = transformed_target(natural, {1: positive()}, dim=10)

    s = NUTS(wrapped, init_with_seed(64, 10, seed=3), 0.8).seed(3)
    s.run(0, 400)
    sample = s.run(600, 100)
    x = np.asarray(tf.to_x(sample)).reshape(-1, 10)
    exact_mu, exact_tau = es8.exact_posterior_means()
    assert abs(float(x[:, 0].mean()) - exact_mu) < 0.3
    assert abs(float(x[:, 1].mean()) - exact_tau) < 0.5
    assert np.all(x[:, 1] > 0)  # tau always in its natural range


def test_wrapped_dc_forms_validate_and_run_fused():
    """A constrained target WITH hand-written dc forms keeps them through
    the transform (per-row composition) — checked by the dc-form
    validator, then driven through parallel tempering, whose replica
    sweep evaluates the wrapped ``logp_dc``."""
    # x0 > 0 scale, x1 unconstrained location: logp = -x0 - (x1/x0)^2 / 2
    def logp_batch(xs):
        return -xs[:, 0] - 0.5 * (xs[:, 1] / xs[:, 0]) ** 2

    target = Target(
        logp=lambda x: -x[0] - 0.5 * (x[1] / x[0]) ** 2,
        logp_batch=logp_batch,
        logp_dc=lambda p: -p[0] - 0.5 * (p[1] / p[0]) ** 2,
    )
    wrapped, tf = transformed_target(target, {0: positive()}, dim=2)
    assert wrapped.logp_dc is not None
    pos = init_det(16, 2)
    validate_dc_forms(wrapped, pos)  # wrapped dc form == wrapped batch form

    pt = ParallelTempering(wrapped, pos, betas=(1.0, 0.5),
                           proposal_std=0.3).seed(5).run(10, 5)
    assert np.all(np.isfinite(np.asarray(pt)))
    assert np.all(np.asarray(tf.to_x(pt))[:, :, 0] > 0)


def test_grad_dc_composition_through_transform():
    import dataclasses

    def logp_batch(xs):
        return -xs[:, 0] - 0.5 * (xs[:, 1] / xs[:, 0]) ** 2

    base = Target(
        logp=lambda x: -x[0] - 0.5 * (x[1] / x[0]) ** 2,
        logp_batch=logp_batch,
        logp_dc=lambda p: -p[0] - 0.5 * (p[1] / p[0]) ** 2,
    )
    # hand dc gradient for the base density
    base = dataclasses.replace(
        base,
        grad_dc=lambda p: jnp.stack(
            [-1.0 + (p[1] ** 2) / (p[0] ** 3), -p[1] / (p[0] ** 2)]
        ),
    )
    wrapped, _ = transformed_target(base, {0: positive()}, dim=2)
    assert wrapped.grad_dc is not None
    y = jax.random.normal(jax.random.PRNGKey(1), (16, 2))
    _, want = wrapped.batch_logp_and_grad(y)
    got = wrapped.grad_dc(y.T).T
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_identity_transform_is_passthrough():
    t = Target(logp=lambda x: -0.5 * jnp.sum(x * x))
    wrapped, tf = transformed_target(t, {}, dim=4)
    assert wrapped is t and tf.is_identity
    y = jnp.ones((2, 4))
    np.testing.assert_array_equal(np.asarray(tf.to_x(y)), np.asarray(y))


def _scale_location_target():
    """x0 > 0 scale, x1 unconstrained: logp = -x0 - (x1/x0)^2/2 - log x0."""
    def logp_batch(xs):
        return (-xs[:, 0] - 0.5 * (xs[:, 1] / xs[:, 0]) ** 2
                - jnp.log(xs[:, 0]))

    return Target(
        logp=lambda x: -x[0] - 0.5 * (x[1] / x[0]) ** 2 - jnp.log(x[0]),
        logp_batch=logp_batch,
    )


def _natural_init(n):
    x0 = init_det(n, 2)
    return x0.at[:, 0].set(jnp.exp(0.3 * x0[:, 0]))  # scale coord > 0


def test_transform_kwarg_matches_manual_wrap_hmc_and_nuts():
    """HMC/NUTS(target_natural, x0, transform=tf) must equal the manual
    wrap + to_y init + to_x(samples) pattern DRAW FOR DRAW (identical
    kernel target and key stream), with .positions in natural range."""
    natural = _scale_location_target()
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = _natural_init(16)

    auto = HMC(natural, x0, 0.05, 3, transform=tf).seed(4)
    manual = HMC(tf.wrap(natural), tf.to_y(x0), 0.05, 3).seed(4)
    sa = auto.run(20, 5)
    sm = tf.to_x(manual.run(20, 5))
    np.testing.assert_allclose(np.asarray(sa), np.asarray(sm),
                               rtol=1e-6, atol=1e-7)
    assert np.all(np.asarray(auto.positions)[:, 0] > 0)

    n_auto = NUTS(natural, x0, 0.8, transform=tf).seed(5)
    n_manual = NUTS(tf.wrap(natural), tf.to_y(x0), 0.8).seed(5)
    sa = n_auto.run(15, 10)
    sm = tf.to_x(n_manual.run(15, 10))
    np.testing.assert_allclose(np.asarray(sa), np.asarray(sm),
                               rtol=1e-6, atol=1e-7)
    assert np.all(np.asarray(n_auto.positions)[:, 0] > 0)


def test_transform_composes_with_metric_warmup():
    """tuned/reconditioned/warmed_up on a transformed sampler: the metric
    is estimated from (and whitens) the UNCONSTRAINED ensemble; samples
    and .positions stay natural; the tuned continuation keeps sampling
    the right posterior (support + finite check + rough moments)."""
    natural = _scale_location_target()
    tf = CoordinateTransform({0: positive()}, dim=2)
    s = HMC(natural, _natural_init(64), 0.1, 5, transform=tf).seed(6)
    warmed = s.warmed_up(100, "diag")
    assert warmed.metric is not None and warmed.transform is tf
    sample = warmed.run(300, 100)
    x = np.asarray(sample).reshape(-1, 2)
    assert np.isfinite(x).all() and np.all(x[:, 0] > 0)
    # E[x0] for the Gamma-like scale marginal p(x0) ∝ x0^-1 e^-x0 ∫e^-(x1/x0)^2/2 dx1
    # = x0^-1 e^-x0 * x0 * sqrt(2pi) -> x0 ~ Exp(1): E = 1, and x1 | x0
    # ~ N(0, x0^2) -> E[x1] = 0.
    assert abs(x[:, 0].mean() - 1.0) < 0.15
    assert abs(x[:, 1].mean()) < 0.2

    # NUTS path: reconditioned with a transform estimates the metric in
    # unconstrained coordinates and continues in-support
    n = NUTS(natural, _natural_init(64), 0.8, transform=tf).seed(7)
    n.run(0, 150)
    tuned = n.reconditioned("diag")
    sample = tuned.run(100, 100)
    assert np.all(np.asarray(sample)[:, :, 0] > 0)


def test_transform_chees_and_mala():
    from mini_mcmc_tpu import MALA, ChEESHMC

    natural = _scale_location_target()
    tf = CoordinateTransform({0: positive()}, dim=2)
    ch = ChEESHMC(natural, _natural_init(128), step_size=0.2,
                  max_leapfrog=32, seed=8, transform=tf).warmed_up(80)
    assert ch.transform is tf
    s = ch.run(100, 50)
    assert np.all(np.asarray(s)[:, :, 0] > 0)

    ml = MALA(natural, _natural_init(32), 0.3, transform=tf).seed(9)
    ml2 = ml.tuned(50)
    assert ml2.transform is tf
    assert np.all(np.asarray(ml2.run(50, 0))[:, :, 0] > 0)


def test_transform_checkpoint_guard(tmp_path):
    """The state lives in unconstrained coordinates: restoring through a
    DIFFERENT transform must raise (the metric-guard convention), and a
    same-transform round-trip continues bit-exactly in natural space."""
    from mini_mcmc_tpu.checkpoint import restore_sampler, save_sampler

    natural = _scale_location_target()
    tf = CoordinateTransform({0: positive()}, dim=2)
    s = HMC(natural, _natural_init(8), 0.05, 3, transform=tf).seed(1)
    s.run(5, 0)
    path = str(tmp_path / "tf_ckpt")
    save_sampler(path, s)

    # same transform: bit-exact continuation
    r = HMC(natural, _natural_init(8), 0.05, 3, transform=tf).seed(99)
    restore_sampler(path, r)
    np.testing.assert_array_equal(np.asarray(s.run(5, 0)),
                                  np.asarray(r.run(5, 0)))

    # different transform (coordinate 1 constrained instead): rejected
    other = CoordinateTransform({1: positive()}, dim=2)
    bad = HMC(natural, _natural_init(8), 0.05, 3, transform=other).seed(0)
    with pytest.raises(ValueError, match="transform"):
        restore_sampler(path, bad)
    # no transform at all: also rejected
    plain = HMC(natural, _natural_init(8), 0.05, 3).seed(0)
    with pytest.raises(ValueError, match="transform"):
        restore_sampler(path, plain)


def test_transform_gradient_free_samplers():
    """MH / slice / ensemble / PT take transform= too: kernels walk the
    unconstrained space, the cube and .positions stay natural."""
    from mini_mcmc_tpu import (
        EnsembleSampler,
        MetropolisHastings,
        ParallelTempering,
        SliceSampler,
    )
    from mini_mcmc_tpu.models import isotropic_gaussian_proposal

    natural = _scale_location_target()
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = _natural_init(32)

    mh = MetropolisHastings(natural, isotropic_gaussian_proposal(0.6), x0,
                            transform=tf).seed(3)
    s = mh.run(300, 100)
    assert np.all(np.asarray(s)[:, :, 0] > 0)
    assert np.all(np.asarray(mh.positions)[:, 0] > 0)
    # draw-for-draw against the manual wrap (same kernel, same keys)
    manual = MetropolisHastings(tf.wrap(natural),
                                isotropic_gaussian_proposal(0.6),
                                tf.to_y(x0)).seed(3)
    np.testing.assert_allclose(np.asarray(s),
                               np.asarray(tf.to_x(manual.run(300, 100))),
                               rtol=1e-6, atol=1e-7)
    # tuned() rebuild keeps the transform (and natural coordinates)
    tuned = mh.tuned(50)
    assert tuned.transform is tf
    assert np.all(np.asarray(tuned.run(50, 0))[:, :, 0] > 0)

    sl = SliceSampler(natural, x0, width="auto", transform=tf).seed(4)
    assert np.all(np.asarray(sl.run(100, 50))[:, :, 0] > 0)

    es = EnsembleSampler(natural, _natural_init(64), transform=tf).seed(5)
    assert np.all(np.asarray(es.run(100, 50))[:, :, 0] > 0)

    pt = ParallelTempering(natural, x0, betas=(1.0, 0.5), proposal_std=0.7,
                           transform=tf).seed(6)
    s = pt.run(100, 50)
    assert s.shape == (32, 100, 2) and np.all(np.asarray(s)[:, :, 0] > 0)
    assert np.all(np.asarray(pt.positions)[:, 0] > 0)
    rt = pt.retuned(2)
    assert rt.transform is tf
    assert np.all(np.asarray(rt.run(20, 0))[:, :, 0] > 0)


def test_out_of_range_natural_inits_raise():
    """Initial positions outside a constrained coordinate's range map to
    NaN/-inf under to_y and would freeze that chain silently (cached NaN
    logp/grad); construction must reject them by name (code-review r5)."""
    natural = _scale_location_target()
    tf = CoordinateTransform({0: positive()}, dim=2)
    x0 = np.asarray(_natural_init(8)).copy()
    x0[2, 0] = -1.0  # outside (0, inf)
    with pytest.raises(ValueError, match="non-finite"):
        HMC(natural, x0, 0.05, 3, transform=tf)
    with pytest.raises(ValueError, match="non-finite"):
        NUTS(natural, x0, 0.8, transform=tf)
    # out-of-range on the interval side too (p > 1), via a gradient-free
    # sampler (same wrap path)
    from mini_mcmc_tpu import MetropolisHastings
    from mini_mcmc_tpu.models import isotropic_gaussian_proposal

    tfi = CoordinateTransform({1: interval(0.0, 1.0)}, dim=2)
    xb = np.asarray(_natural_init(8)).copy()
    xb[:, 1] = 0.5
    xb[1, 1] = 1.5  # outside (0, 1)
    with pytest.raises(ValueError, match="non-finite"):
        MetropolisHastings(natural, isotropic_gaussian_proposal(0.5), xb,
                           transform=tfi)
    # EXACT boundary values do not error: the saturating inverse snaps
    # them just inside the range (log(0) -> the soft-saturation edge)
    xs = np.asarray(_natural_init(8)).copy()
    xs[2, 0] = 0.0
    y = tf.to_y(xs)
    assert np.all(np.isfinite(np.asarray(y)))
    assert np.all(np.asarray(tf.to_x(y))[:, 0] > 0)


def test_builtin_bijectors_group_into_one_masked_pass():
    """The builtin factories are cached: the natural per-coordinate
    construction {i: positive() for i in range(d)} must collapse to ONE
    masked whole-array pass, not d of them (code-review r5: id-grouping
    over uncached factories was O(d) passes -> O(d^2) work)."""
    from mini_mcmc_tpu.models.transforms import Bijector

    d = 10_000
    tf = CoordinateTransform({i: positive() for i in range(d)}, dim=d)
    assert len(tf._groups) == 1
    mixed = CoordinateTransform(
        {0: positive(), 1: interval(0.0, 1.0), 2: interval(0.0, 1.0),
         3: positive(), 4: lower_bounded(2.0), 5: lower_bounded(2.0)},
        dim=8,
    )
    assert len(mixed._groups) == 3
    # distinct parameterizations never merge
    two = CoordinateTransform({0: interval(0.0, 1.0), 1: interval(0.0, 2.0)},
                              dim=2)
    assert len(two._groups) == 2
    # custom Bijector instances group by identity only
    mk = lambda: Bijector(jnp.exp, jnp.log, lambda y: y)  # noqa: E731
    a, b = mk(), mk()
    custom = CoordinateTransform({0: a, 1: a, 2: b}, dim=3)
    assert len(custom._groups) == 2


def test_checkpoint_probe_distinguishes_same_named_custom_bijectors(tmp_path):
    """Two DIFFERENT custom maps that both kept the default name must not
    fingerprint-collide: the numeric-probe crc catches what the name crc
    cannot (code-review r5). A numerically identical fresh instance still
    restores (the probe keys on behavior, not object identity)."""
    from mini_mcmc_tpu import MetropolisHastings
    from mini_mcmc_tpu.checkpoint import restore_sampler, save_sampler
    from mini_mcmc_tpu.models import gaussian2d, isotropic_gaussian_proposal
    from mini_mcmc_tpu.models.transforms import Bijector

    def mk_exp():  # default name "bijector"
        return Bijector(jnp.exp, jnp.log, lambda y: y)

    def mk_softplus():  # also default name "bijector", different map
        return Bijector(
            lambda y: jnp.logaddexp(y, 0.0),
            lambda x: x + jnp.log(-jnp.expm1(-x)),
            lambda y: -jnp.log1p(jnp.exp(-y)),
        )

    target = gaussian2d([1.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    prop = isotropic_gaussian_proposal(0.4)
    x0 = np.abs(np.asarray(init_det(8, 2))) + 0.5

    tf_a = CoordinateTransform({0: mk_exp()}, dim=2)
    s = MetropolisHastings(target, prop, x0, transform=tf_a).seed(1)
    s.run(3, 0)
    path = str(tmp_path / "custom_tf")
    save_sampler(path, s)

    # same map, fresh instance: restores
    ok = MetropolisHastings(
        target, prop, x0, transform=CoordinateTransform({0: mk_exp()}, dim=2)
    ).seed(9)
    restore_sampler(path, ok)

    # different map, same (default) name: rejected
    bad = MetropolisHastings(
        target, prop, x0,
        transform=CoordinateTransform({0: mk_softplus()}, dim=2),
    ).seed(9)
    with pytest.raises(ValueError, match="transform"):
        restore_sampler(path, bad)
