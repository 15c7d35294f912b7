"""Gibbs sampler tests.

Mirrors the reference's Gibbs checks (/root/reference/src/gibbs.rs:289-445):
constant-conditional convergence after one sweep, and 2-component Gaussian
mixture moment matching within 10% of theory (gibbs.rs:341-418).
"""

import jax.numpy as jnp
import numpy as np

from mini_mcmc_tpu import GibbsSampler
from mini_mcmc_tpu.models import (
    constant_conditional,
    gaussian_mixture_conditional,
)


def test_gibbs_constant_conditional_one_sweep():
    # After one sweep every coordinate equals the constant
    # (gibbs.rs:289-335).
    cond = constant_conditional(7.0)
    sampler = GibbsSampler(cond, jnp.zeros((3, 3))).seed(0)
    sample = sampler.run(1, 0)
    np.testing.assert_allclose(np.asarray(sample), 7.0)


def test_gibbs_mixture_moments():
    # Reference parameter set 1 (gibbs.rs:390-402): state [x, z], mixture
    # 0.5*N(-2, 1^2) + 0.5*N(3, 1.5^2); mean/var within 10% of theory
    # (gibbs.rs:374-386).
    mu0, sigma0, mu1, sigma1, pi0 = -2.0, 1.0, 3.0, 1.5, 0.5
    cond = gaussian_mixture_conditional(mu0, sigma0, mu1, sigma1, pi0)
    init = jnp.zeros((8, 2))
    sampler = GibbsSampler(cond, init).seed(42)
    sample = sampler.run(25000, 2500)
    xs = np.asarray(sample[:, :, 0]).ravel()

    true_mean = pi0 * mu0 + (1 - pi0) * mu1
    true_var = pi0 * (sigma0**2 + (mu0 - true_mean) ** 2) + (1 - pi0) * (
        sigma1**2 + (mu1 - true_mean) ** 2
    )
    assert abs(xs.mean() - true_mean) < abs(true_mean) / 10.0, xs.mean()
    assert abs(xs.var() - true_var) < true_var / 10.0, xs.var()

    # latent indicator frequency matches mixing weight
    zs = np.asarray(sample[:, :, 1]).ravel()
    assert abs(zs.mean() - (1 - pi0)) < 0.05, zs.mean()


def test_gibbs_determinism():
    cond = gaussian_mixture_conditional(-2.0, 0.5, 3.0, 1.0, 0.3)
    a = GibbsSampler(cond, jnp.zeros((2, 2))).seed(1).run(50, 0)
    b = GibbsSampler(cond, jnp.zeros((2, 2))).seed(1).run(50, 0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gibbs_block_fn_contract():
    # the XLA K-sweep block (steps_per_call>1) must equal K
    # applications of step_fn on the block key's K sub-keys, recording
    # every intermediate state (nothing thinned)
    import jax

    from mini_mcmc_tpu.ops.gibbs import gibbs_kernel

    cond = gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5)
    init_fn, step_fn = gibbs_kernel(cond, steps_per_call=4)
    state = init_fn(jnp.zeros((6, 2)))
    key = jax.random.PRNGKey(3)
    out_state, rows = step_fn.block_fn(state, key)

    s = state
    expected = []
    for sub in jax.random.split(key, 4):
        s = step_fn(s, sub)
        expected.append(np.asarray(s.positions))
    np.testing.assert_array_equal(np.asarray(rows), np.stack(expected))
    np.testing.assert_array_equal(np.asarray(out_state.positions),
                                  expected[-1])


def test_gibbs_steps_per_call_sampler_statistics():
    # the block-fused sampler must reproduce the mixture's moments (same
    # gates as the per-step path; different key schedule, so equality with
    # the per-step run is not expected)
    mu0, sigma0, mu1, sigma1, pi0 = -2.0, 1.0, 3.0, 1.5, 0.5
    cond = gaussian_mixture_conditional(mu0, sigma0, mu1, sigma1, pi0)
    sampler = GibbsSampler(cond, jnp.zeros((64, 2)),
                           steps_per_call=8).seed(9)
    sample = sampler.run(4000, 400)
    assert sample.shape == (64, 4000, 2)
    xs = np.asarray(sample[:, :, 0]).ravel()
    true_mean = pi0 * mu0 + (1 - pi0) * mu1
    true_var = pi0 * (sigma0**2 + (mu0 - true_mean) ** 2) + (1 - pi0) * (
        sigma1**2 + (mu1 - true_mean) ** 2
    )
    assert abs(xs.mean() - true_mean) < abs(true_mean) / 10.0, xs.mean()
    assert abs(xs.var() - true_var) < true_var / 10.0, xs.var()


def test_gibbs_sequential_sweep_uses_fresh_values():
    # Coordinate 1 must see the freshly updated coordinate 0 within the
    # same sweep (gibbs.rs:95-99). A conditional that copies coordinate 0
    # into coordinate 1 proves the ordering.
    import jax

    from mini_mcmc_tpu.models.base import Conditional

    def sample(key, index, state):
        return jax.lax.cond(
            index == 0,
            lambda: state[0] + 1.0,
            lambda: state[0],  # must observe the incremented value
        )

    cond = Conditional(sample=sample)
    sampler = GibbsSampler(cond, jnp.zeros((1, 2))).seed(0)
    sample_out = sampler.run(1, 0)
    np.testing.assert_allclose(np.asarray(sample_out[0, 0]), [1.0, 1.0])
