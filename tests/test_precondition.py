"""Metric (whitening preconditioner) tests — a beyond-reference feature.

The preconditioner runs unit-metric HMC/NUTS on the whitened target
``logp_y(y) = logp_x(L y)``, which is the classical equivalence to a
``(L L^T)^-1`` mass matrix (models/precondition.py). Tests pin the
transform algebra against AD, statistical correctness of the mapped
samples, the efficiency win on an anisotropic target, and that the
default (no metric) path is bit-identical to before (golden tests in
test_golden_trajectories.py already pin that stream).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_mcmc_tpu import HMC, NUTS, init_det, split_rhat_mean_ess
from mini_mcmc_tpu.models import (
    diffable_gaussian2d,
    estimate_preconditioner,
    precondition_target,
    rosenbrock_nd,
)
from mini_mcmc_tpu.models.precondition import Preconditioner

COV = [[4.0, 2.0], [2.0, 3.0]]


def _dense_pre():
    return Preconditioner(
        kind="dense", chol=jnp.linalg.cholesky(jnp.asarray(COV))
    )


def _diag_pre():
    return Preconditioner(kind="diag", scale=jnp.asarray([2.0, 0.5]))


@pytest.mark.parametrize("pre", [_diag_pre(), _dense_pre()],
                         ids=["diag", "dense"])
def test_transform_roundtrip_and_gradients(pre):
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (7, 2), jnp.float64)
    np.testing.assert_allclose(
        np.asarray(pre.to_x(pre.to_y(x))), np.asarray(x), rtol=1e-12
    )
    target = diffable_gaussian2d([0.5, -1.0], COV)
    wrapped = precondition_target(target, pre)
    y = pre.to_y(x)
    # logp parity: logp_y(y) == logp_x(x)
    np.testing.assert_allclose(
        np.asarray(wrapped.batch_logp(y)),
        np.asarray(target.batch_logp(x)),
        rtol=1e-12,
    )
    # analytic chain-rule gradient == AD of the wrapped logp
    ad = jax.vmap(jax.grad(wrapped.logp))(y)
    _, an = wrapped.batch_logp_and_grad(y)
    np.testing.assert_allclose(np.asarray(an), np.asarray(ad), rtol=1e-10)
    # normalized density gains the |det L| volume term: both normalized
    # densities must integrate to one, so a Gaussian quadrature identity:
    # logp_normalized_y(to_y(x)) = logp_normalized_x(x) + log|det L|
    np.testing.assert_allclose(
        np.asarray(jax.vmap(wrapped.logp_normalized)(y)),
        np.asarray(jax.vmap(target.logp_normalized)(x))
        + float(pre.logdet()),
        rtol=1e-10,
    )


@pytest.mark.parametrize("pre", [_diag_pre(), _dense_pre()],
                         ids=["diag", "dense"])
def test_dc_forms_match_batch_forms(pre):
    # the Pallas chains-on-lanes wrappers (unrolled scalar maps) must agree
    # with the row-batched forms
    target = diffable_gaussian2d([0.5, -1.0], COV)
    wrapped = precondition_target(target, pre)
    assert wrapped.logp_dc is not None and wrapped.grad_dc is not None
    key = jax.random.PRNGKey(1)
    y = jax.random.normal(key, (64, 2), jnp.float32)
    y_dc = y.T  # [D, C]
    np.testing.assert_allclose(
        np.asarray(wrapped.logp_dc(y_dc)),
        np.asarray(wrapped.batch_logp(y)),
        rtol=1e-5,
    )
    _, g = wrapped.batch_logp_and_grad(y)
    np.testing.assert_allclose(
        np.asarray(wrapped.grad_dc(y_dc)), np.asarray(g.T), rtol=1e-5
    )


def test_estimate_preconditioner_recovers_covariance():
    key = jax.random.PRNGKey(2)
    chol = jnp.linalg.cholesky(jnp.asarray(COV))
    x = jax.random.normal(key, (200_00, 2), jnp.float64) @ chol.T
    pre_diag = estimate_preconditioner(x, "diag")
    np.testing.assert_allclose(
        np.asarray(pre_diag.scale), [2.0, np.sqrt(3.0)], rtol=0.05
    )
    pre_dense = estimate_preconditioner(x, "dense")
    est_cov = pre_dense.chol @ pre_dense.chol.T
    np.testing.assert_allclose(np.asarray(est_cov), COV, rtol=0.08)
    with pytest.raises(ValueError):
        estimate_preconditioner(x, "full")
    with pytest.raises(ValueError):
        estimate_preconditioner(x[0], "diag")


def test_hmc_with_dense_metric_is_correct_and_more_efficient():
    target = diffable_gaussian2d([0.0, 1.0], COV)
    init = init_det(64, 2)
    plain = HMC(target, init, 0.25, 8).seed(3)
    s_plain = plain.run(500, 200)
    pre = _dense_pre()
    metric = HMC(target, init, 0.9, 8, metric=pre).seed(3)
    s_metric = metric.run(500, 200)
    # correctness: mapped samples hit the x-space moments
    flat = np.asarray(s_metric).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), [0.0, 1.0], atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.45)
    # positions property is x-space (same scale as the target)
    assert float(jnp.std(metric.positions[:, 0])) > 1.0
    # efficiency: whitened dynamics decorrelate faster per draw
    _, ess_plain = split_rhat_mean_ess(s_plain)
    _, ess_metric = split_rhat_mean_ess(s_metric)
    assert float(jnp.min(ess_metric)) > 1.5 * float(jnp.min(ess_plain)), (
        np.asarray(ess_metric), np.asarray(ess_plain))


def test_hmc_reconditioned_continues_from_ensemble():
    target = diffable_gaussian2d([0.0, 1.0], COV)
    hmc = HMC(target, init_det(256, 2), 0.25, 8).seed(4)
    hmc.run(0, 300)  # equilibrate the ensemble
    tuned = hmc.reconditioned("dense", seed=5)
    # the estimated metric should be close to the target covariance
    est_cov = tuned.metric.chol @ tuned.metric.chol.T
    np.testing.assert_allclose(np.asarray(est_cov), COV, rtol=0.35)
    s = tuned.run(400, 0)
    flat = np.asarray(s).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), [0.0, 1.0], atol=0.2)


def test_hmc_metric_block_runner_rows_are_x_space():
    # steps_per_call > 1: the block rows must be un-whitened too (the
    # block key schedule differs from the per-step runner's, so equality
    # with the per-step run is not expected — the tell for y-space leakage
    # is the marginal scale: x-space dim 0 has std 2, whitened would be 1)
    target = diffable_gaussian2d([0.0, 1.0], COV)
    init = init_det(64, 2)
    s = HMC(target, init, 0.9, 8, metric=_dense_pre(),
            steps_per_call=5).seed(6).run(200, 100)
    flat = np.asarray(s).reshape(-1, 2)
    assert flat[:, 0].std() > 1.5, flat[:, 0].std()
    np.testing.assert_allclose(flat.mean(axis=0), [0.0, 1.0], atol=0.25)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.7)


def test_nuts_with_metric_shrinks_trees():
    target = diffable_gaussian2d([0.0, 1.0], COV)
    init = init_det(64, 2)
    plain = NUTS(target, init, 0.8).seed(7)
    s_plain = plain.run(300, 300)
    tuned = NUTS(target, init, 0.8, metric=_dense_pre()).seed(7)
    s_tuned = tuned.run(300, 300)
    flat = np.asarray(s_tuned).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), [0.0, 1.0], atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.5)
    # whitened target is unit-Gaussian: per-draw efficiency at least as
    # good as the unwhitened run (the 2D win is modest; the big win is
    # high condition numbers — covered by the HMC dense test above)
    _, ess_plain = split_rhat_mean_ess(s_plain)
    _, ess_tuned = split_rhat_mean_ess(s_tuned)
    assert float(jnp.min(ess_tuned)) > 0.9 * float(jnp.min(ess_plain)), (
        np.asarray(ess_tuned), np.asarray(ess_plain))


def test_nuts_reconditioned_roundtrip():
    target = diffable_gaussian2d([0.0, 1.0], COV)
    nuts = NUTS(target, init_det(128, 2), 0.8).seed(8)
    nuts.run(50, 100)
    tuned = nuts.reconditioned("diag", seed=9)
    np.testing.assert_allclose(
        np.asarray(tuned.metric.scale), [2.0, np.sqrt(3.0)], rtol=0.35
    )
    s = tuned.run(200, 100)
    assert s.shape == (128, 200, 2)
    flat = np.asarray(s).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), [0.0, 1.0], atol=0.2)


def test_metric_works_on_rosenbrock_diag():
    # non-Gaussian target: diag whitening must stay statistically correct
    target = rosenbrock_nd()
    hmc = HMC(target, init_det(32, 3) * 0.5 + 1.0, 0.02, 64,
              jitter=0.3).seed(10)
    hmc.run(0, 200)
    tuned = hmc.reconditioned("diag", seed=11)
    s = tuned.run(500, 0)
    x0 = np.asarray(s[:, :, 0]).ravel()
    assert abs(x0.mean() - 0.78522) < 0.08, x0.mean()
    assert abs(x0.var() - 0.22937) < 0.08, x0.var()


def test_preconditioner_validates_construction():
    with pytest.raises(ValueError, match="kind"):
        Preconditioner(kind="Diag", scale=jnp.ones(2))
    with pytest.raises(ValueError, match="chol"):
        Preconditioner(kind="dense", scale=jnp.ones(2))
    with pytest.raises(ValueError, match="scale"):
        Preconditioner(kind="diag", chol=jnp.eye(2))


def test_reconditioned_rescales_step_size_for_wide_targets():
    # an x-space-tuned step size carried into whitened coordinates
    # unchanged would blow up leapfrog energy; the default rescale
    # eps_y = eps_x / sigma_min keeps the stiffest dimension's margin
    from mini_mcmc_tpu.models import gaussian2d as _  # noqa: F401
    from mini_mcmc_tpu.models.base import Target

    def logp_batch(x):
        return -0.5 * jnp.sum((x / 100.0) ** 2, axis=-1)

    wide = Target(logp=lambda x: -0.5 * jnp.sum((x / 100.0) ** 2),
                  logp_batch=logp_batch)
    hmc = HMC(wide, init_det(128, 2) * 100.0, 50.0, 8).seed(12)
    hmc.run(0, 300)
    tuned = hmc.reconditioned("diag")
    assert 0.2 < tuned.step_size < 1.5, tuned.step_size  # ~50/sigma(~100)
    s = tuned.run(400, 0)
    flat = np.asarray(s).reshape(-1, 2)
    # healthy mixing at scale 100 (a frozen sampler would keep warmup std)
    assert 75.0 < flat.std() < 130.0, flat.std()


def test_repeated_reconditioning_keeps_step_size_scale():
    # reconditioning a sampler that ALREADY carries a metric: the carried
    # step size is whitened (y-space), so it must be mapped back to x-space
    # before dividing by the new metric's sigma_min — otherwise each round
    # shrinks eps by another factor of sigma_min (ADVICE r2). With a
    # ~scale-100 target, two rounds of the buggy rescale would leave
    # eps ~ 5e-3 instead of ~0.5.
    from mini_mcmc_tpu.models.base import Target

    def logp_batch(x):
        return -0.5 * jnp.sum((x / 100.0) ** 2, axis=-1)

    wide = Target(logp=lambda x: -0.5 * jnp.sum((x / 100.0) ** 2),
                  logp_batch=logp_batch)
    hmc = HMC(wide, init_det(128, 2) * 100.0, 50.0, 8).seed(12)
    hmc.run(0, 300)
    tuned = hmc.reconditioned("diag")
    tuned.run(0, 100)
    tuned2 = tuned.reconditioned("diag")
    assert 0.2 < tuned2.step_size < 1.5, tuned2.step_size
    s = tuned2.run(200, 0)
    assert 70.0 < np.asarray(s).std() < 135.0, np.asarray(s).std()


def test_reconditioned_is_deterministic_without_seed():
    # the README workflow (seed -> warmup -> reconditioned -> run) must be
    # reproducible end-to-end: the derived sampler's key comes from the
    # parent's stream, not OS entropy
    target = diffable_gaussian2d([0.0, 1.0], COV)

    def workflow():
        hmc = HMC(target, init_det(32, 2), 0.25, 8).seed(21)
        hmc.run(0, 100)
        return hmc.reconditioned("dense").run(50, 0)

    np.testing.assert_array_equal(np.asarray(workflow()),
                                  np.asarray(workflow()))


def test_metric_run_progress_is_x_space():
    # the progress path builds its own runner; it must un-whiten too
    import io

    target = diffable_gaussian2d([0.0, 1.0], COV)
    nuts = NUTS(target, init_det(16, 2), 0.8, metric=_dense_pre()).seed(14)
    sample, stats = nuts.run_progress(60, 20, stream=io.StringIO())
    assert sample.shape == (16, 60, 2)
    flat = np.asarray(sample).reshape(-1, 2)
    assert flat[:, 0].std() > 1.2, flat[:, 0].std()  # x-space scale (std 2)
    hmc = HMC(target, init_det(16, 2), 0.9, 8, metric=_dense_pre()).seed(15)
    sample, _ = hmc.run_progress(60, 20, stream=io.StringIO())
    flat = np.asarray(sample).reshape(-1, 2)
    assert flat[:, 0].std() > 1.2, flat[:, 0].std()


def test_nuts_warmed_up_one_call_workflow():
    # warmed_up = adapt in place + reconditioned: same endpoint as the
    # manual two-call workflow, uniform with HMC/MALA's warmed_up API
    target = diffable_gaussian2d([0.0, 1.0], COV)
    nuts = NUTS(target, init_det(128, 2), 0.8).seed(8)
    w = nuts.warmed_up(150, "diag", seed=9)
    np.testing.assert_allclose(
        np.asarray(w.metric.scale), [2.0, np.sqrt(3.0)], rtol=0.35
    )
    s = w.run(200, 100)
    flat = np.asarray(s).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), [0.0, 1.0], atol=0.2)
    # the adaptation leg advanced the parent's chains in place
    assert not np.allclose(np.asarray(nuts.positions),
                           np.asarray(init_det(128, 2)))
