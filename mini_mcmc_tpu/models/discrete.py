"""Discrete distributions and integer-state proposals.

Covers the reference's ``Categorical`` (/root/reference/src/distributions.rs:421-477),
and the Poisson / Binomial targets and +-1 random-walk proposal its
integration tests build by hand (/root/reference/tests/metrohast_poisson_test.rs:19-105,
:150-218). States are integer dtype arrays: the MH kernel is dtype-generic,
matching the reference's support for ``usize``/``i32`` state types
(/root/reference/src/lib.rs:153-209).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Proposal, Target


class Categorical:
    """Categorical distribution over ``len(probs)`` categories.

    Normalizing constructor plus ``sample``/``logp`` mirroring the
    reference's ``Discrete`` trait (/root/reference/src/distributions.rs:129-134),
    with an explicit PRNG key instead of internal RNG state. Also usable as
    an integer-state MH target via :meth:`target`.
    """

    def __init__(self, probs):
        probs = jnp.asarray(probs)
        self.probs = probs / jnp.sum(probs)

    def sample(self, key, shape=()):
        return jax.random.categorical(key, jnp.log(self.probs), shape=shape)

    def logp(self, index):
        index = jnp.asarray(index)
        in_range = (index >= 0) & (index < self.probs.shape[0])
        safe = jnp.clip(index, 0, self.probs.shape[0] - 1)
        return jnp.where(in_range, jnp.log(self.probs[safe]), -jnp.inf)

    def target(self) -> Target:
        """Integer-state target: ``unnorm_logp([k]) = logp(k)``
        (/root/reference/src/distributions.rs:471-477)."""

        def logp(state):
            return self.logp(state[0])

        return Target(logp=logp)


def poisson_target(lam) -> Target:
    """Poisson(lambda) over 1-dim integer states.

    ``logp(k) = k ln(lam) - lam - ln(k!)``, -inf for k < 0
    (/root/reference/tests/metrohast_poisson_test.rs:23-35).
    """
    log_lam = jnp.log(lam)

    def logp(state):
        k = state[0]
        kf = k.astype(jnp.float32)
        lp = kf * log_lam - lam - jax.lax.lgamma(kf + 1.0)
        return jnp.where(k < 0, -jnp.inf, lp)

    # The dc form bakes its coefficients in as Python floats; a traced lam
    # (target built under jit/vmap over hyperparameters) drops it (same
    # guard as models/gaussian._concrete_floats).
    from .gaussian import _concrete_floats

    coeffs = _concrete_floats(log_lam, lam)
    logp_dc = None
    if coeffs is not None:
        log_lam_f, lam_f = coeffs

        def logp_dc(pos_dc):
            k = pos_dc[0]
            kf = k.astype(jnp.float32)
            lp = kf * log_lam_f - lam_f - jax.lax.lgamma(kf + 1.0)
            return jnp.where(k < 0, -jnp.inf, lp)

    return Target(logp=logp, logp_dc=logp_dc)


def binomial_target(n, p) -> Target:
    """Binomial(n, p) over 1-dim integer states, -inf outside [0, n]
    (/root/reference/tests/metrohast_poisson_test.rs:150-176)."""
    logp_, log1mp = jnp.log(p), jnp.log1p(-p)
    nf = float(n)

    def logp(state):
        k = state[0]
        kf = k.astype(jnp.float32)
        log_choose = (
            jax.lax.lgamma(nf + 1.0)
            - jax.lax.lgamma(kf + 1.0)
            - jax.lax.lgamma(nf - kf + 1.0)
        )
        lp = log_choose + kf * logp_ + (nf - kf) * log1mp
        return jnp.where((k < 0) | (k > n), -jnp.inf, lp)

    return Target(logp=logp)


def random_walk_int_proposal(clip_low=0, clip_high=None) -> Proposal:
    """Symmetric +-1 integer random walk, reflecting at ``clip_low``
    (and optionally at ``clip_high``), matching ``PoissonRandomWalk``
    (/root/reference/tests/metrohast_poisson_test.rs:52-105)."""

    def sample(key, current):
        step = jnp.where(
            jax.random.bernoulli(key, 0.5, current.shape),
            jnp.ones_like(current),
            -jnp.ones_like(current),
        )
        new = current + step
        new = jnp.maximum(new, jnp.asarray(clip_low, current.dtype))
        if clip_high is not None:
            new = jnp.minimum(new, jnp.asarray(clip_high, current.dtype))
        return new

    def logp(frm, to):
        del frm, to
        return jnp.log(0.5)

    return Proposal(sample=sample, logp=logp, sample_batch=sample)
