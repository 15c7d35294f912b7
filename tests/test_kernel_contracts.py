"""Contracts shared by the step kernels.

- The XLA K-step block (``steps_per_call > 1``): ``step_fn.block_fn(state,
  key)`` equals K applications of ``step_fn`` on the block key's K
  sub-keys and records every intermediate position (nothing thinned).
- HMC's integrator (``step_fn.leapfrog``) against a hand-rolled leapfrog.
- Samplers and kernels take no fused-tier parameters: passing one is a
  ``TypeError``, never a silent fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_mcmc_tpu import (
    HMC,
    MALA,
    NUTS,
    GibbsSampler,
    MetropolisHastings,
    ParallelTempering,
    init_det,
)
from mini_mcmc_tpu.models import (
    gaussian2d,
    gaussian_mixture_conditional,
    isotropic_gaussian_proposal,
    neal_funnel,
    rosenbrock_nd,
    standard_normal,
)
from mini_mcmc_tpu.models.base import Target


def _hmc():
    from mini_mcmc_tpu.ops.hmc import hmc_kernel

    return hmc_kernel(rosenbrock_nd(), 0.03, 5, steps_per_call=4)


def _mala():
    from mini_mcmc_tpu.ops.hmc import hmc_kernel

    return hmc_kernel(rosenbrock_nd(), 0.05, 1, unroll=1, steps_per_call=4)


def _mh():
    from mini_mcmc_tpu.ops.mh import mh_kernel

    return mh_kernel(gaussian2d([0.0, 0.0], [[2.0, 0.5], [0.5, 1.0]]),
                     isotropic_gaussian_proposal(1.0), steps_per_call=4)


def _gibbs():
    from mini_mcmc_tpu.ops.gibbs import gibbs_kernel

    return gibbs_kernel(
        gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5),
        steps_per_call=4)


def _slice():
    from mini_mcmc_tpu.ops.slice import slice_kernel

    return slice_kernel(standard_normal(), steps_per_call=4)


def _ensemble():
    from mini_mcmc_tpu.ops.ensemble import ensemble_kernel

    return ensemble_kernel(standard_normal(), walkers_per_ensemble=6,
                           steps_per_call=4)


def _elliptical():
    from mini_mcmc_tpu.ops.elliptical import elliptical_kernel

    loglik = Target(logp=lambda x: -0.5 * jnp.sum((x - 1.0) ** 2))
    return elliptical_kernel(loglik, steps_per_call=4)


BLOCK_KERNELS = {
    "hmc": (_hmc, 3),
    "mala": (_mala, 3),
    "mh": (_mh, 2),
    "gibbs": (_gibbs, 2),
    "slice": (_slice, 2),
    "ensemble": (_ensemble, 2),
    "elliptical": (_elliptical, 2),
}


@pytest.mark.parametrize("name", sorted(BLOCK_KERNELS))
def test_block_fn_equals_k_steps(name):
    build, dim = BLOCK_KERNELS[name]
    init_fn, step_fn = build()
    assert step_fn.block_size == 4
    state = init_fn(0.5 * init_det(6, dim))
    key = jax.random.PRNGKey(3)
    out_state, rows = step_fn.block_fn(state, key)
    assert rows.shape == (4, 6, dim)

    s = state
    expected = []
    for sub in jax.random.split(key, 4):
        s = step_fn(s, sub)
        expected.append(np.asarray(s.positions))
    # fp32-ulp tolerance: the block scan and the eager per-step loop fuse
    # differently under XLA (same draws, same accepts, reassociated adds)
    np.testing.assert_allclose(np.asarray(rows), np.stack(expected),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_state.positions),
                               expected[-1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("target_name", ["rosenbrock", "standard_normal",
                                         "funnel"])
def test_hmc_leapfrog_matches_hand_rolled(target_name):
    from mini_mcmc_tpu.ops.hmc import hmc_kernel

    target = {"rosenbrock": rosenbrock_nd, "standard_normal": standard_normal,
              "funnel": neal_funnel}[target_name]()
    eps, n_leapfrog = 0.02, 7
    key = jax.random.PRNGKey(1)
    pos = 0.5 * jax.random.normal(key, (8, 3), jnp.float32)
    mom = jax.random.normal(jax.random.fold_in(key, 1), (8, 3), jnp.float32)
    logp, grad = target.batch_logp_and_grad(pos)
    _, step_fn = hmc_kernel(target, eps, n_leapfrog)
    out = step_fn.leapfrog(pos, mom, logp, grad, jnp.float32(eps))

    x, m, g = pos, mom, grad
    for _ in range(n_leapfrog):
        m = m + 0.5 * eps * g
        x = x + eps * m
        _, g = target.batch_logp_and_grad(x)
        m = m + 0.5 * eps * g
    ref = (x, m, target.batch_logp(x), g)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _sampler_ctor(name):
    g2 = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    pos = init_det(4, 2)
    return {
        "MetropolisHastings": lambda **kw: MetropolisHastings(
            g2, isotropic_gaussian_proposal(1.0), pos, **kw),
        "HMC": lambda **kw: HMC(g2, pos, 0.1, 2, **kw),
        "MALA": lambda **kw: MALA(g2, pos, 0.1, **kw),
        "NUTS": lambda **kw: NUTS(g2, pos, 0.8, **kw),
        "ParallelTempering": lambda **kw: ParallelTempering(
            g2, pos, betas=(1.0, 0.5), **kw),
        "GibbsSampler": lambda **kw: GibbsSampler(
            gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5),
            pos, **kw),
    }[name]


@pytest.mark.parametrize("name,param,value", [
    ("MetropolisHastings", "use_pallas", "full"),
    ("HMC", "use_pallas", True),
    ("HMC", "pallas_interpret", True),
    ("HMC", "validate_dc", False),
    ("MALA", "use_pallas", True),
    ("NUTS", "use_pallas", "full"),
    ("ParallelTempering", "use_pallas", "full"),
    ("GibbsSampler", "use_pallas", "full"),
])
def test_samplers_reject_fused_tier_parameters(name, param, value):
    with pytest.raises(TypeError, match=param):
        _sampler_ctor(name)(**{param: value})


@pytest.mark.parametrize("kernel", ["hmc", "mh", "gibbs", "tempering",
                                    "nuts"])
def test_kernels_reject_use_pallas(kernel):
    from mini_mcmc_tpu.ops.gibbs import gibbs_kernel
    from mini_mcmc_tpu.ops.hmc import hmc_kernel
    from mini_mcmc_tpu.ops.mh import mh_kernel
    from mini_mcmc_tpu.ops.nuts import nuts_kernel
    from mini_mcmc_tpu.ops.tempering import tempering_kernel

    g2 = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    build = {
        "hmc": lambda **kw: hmc_kernel(g2, 0.1, 2, **kw),
        "mh": lambda **kw: mh_kernel(g2, isotropic_gaussian_proposal(1.0),
                                     **kw),
        "gibbs": lambda **kw: gibbs_kernel(
            gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5), **kw),
        "tempering": lambda **kw: tempering_kernel(g2, (1.0, 0.5), **kw),
        "nuts": lambda **kw: nuts_kernel(g2, 0.8, **kw),
    }[kernel]
    with pytest.raises(TypeError, match="use_pallas"):
        build(use_pallas="full")
