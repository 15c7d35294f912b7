"""Gibbs conditionals: 2-component Gaussian mixture with a latent indicator.

Behavioral port of the reference's ``MixtureConditional`` test fixture and
``mixture_gibbs`` example (/root/reference/src/gibbs.rs:235-286,
/root/reference/examples/mixture_gibbs.rs): state is ``[x, z]`` where z in
{0, 1} selects the mixture component.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .base import Conditional


def gaussian_mixture_conditional(mu0, sigma0, mu1, sigma1, pi0) -> Conditional:
    """Full conditionals for the latent-indicator mixture model.

    - ``x | z``: N(mu_z, sigma_z^2)
    - ``z | x``: Bernoulli with p(z=1|x) proportional to (1-pi0) * N(x; mu1, sigma1)
    """

    def normal_pdf(x, mu, sigma):
        var = sigma * sigma
        coeff = 1.0 / jnp.sqrt(2.0 * math.pi * var)
        return coeff * jnp.exp(-((x - mu) ** 2) / (2.0 * var))

    def sample(key, index, state):
        # shape-generic: works for one chain ([2]) and batched ([C, 2])
        def sample_x(key):
            z = state[..., 1]
            mu = jnp.where(z < 0.5, mu0, mu1)
            sigma = jnp.where(z < 0.5, sigma0, sigma1)
            return mu + sigma * jax.random.normal(key, z.shape, state.dtype)

        def sample_z(key):
            x = state[..., 0]
            p0 = pi0 * normal_pdf(x, mu0, sigma0)
            p1 = (1.0 - pi0) * normal_pdf(x, mu1, sigma1)
            total = p0 + p1
            prob_z1 = jnp.where(total > 0.0, p1 / total, 0.5)
            u = jax.random.uniform(key, x.shape, state.dtype)
            return jnp.where(u < prob_z1, 1.0, 0.0).astype(state.dtype)

        return jax.lax.cond(index == 0, sample_x, sample_z, key)

    return Conditional(sample=sample, sample_batch=sample)


def constant_conditional(value) -> Conditional:
    """Test fixture: every coordinate resamples to the constant ``value``
    (/root/reference/src/gibbs.rs:217-226)."""

    def sample(key, index, state):
        del key, index
        return jnp.asarray(value, state.dtype)

    return Conditional(sample=sample)
