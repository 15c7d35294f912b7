"""Rosenbrock targets (2D and N-D).

Behavioral parity with ``Rosenbrock2D`` (/root/reference/src/distributions.rs:490-524)
and ``RosenbrockND`` (:526-547, arXiv:1903.09556 form). Both carry analytic
gradients and fused batched forms so the HMC hot path needs no AD replay.
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import Target


def rosenbrock2d(a=1.0, b=100.0) -> Target:
    """2D Rosenbrock: ``logp = -((a - x)^2 + b * (y - x^2)^2)``."""

    def logp(pos):
        x, y = pos[0], pos[1]
        return -((a - x) ** 2 + b * (y - x * x) ** 2)

    def logp_batch(positions):
        x = positions[:, 0]
        y = positions[:, 1]
        return -((a - x) ** 2 + b * (y - x * x) ** 2)

    def grad(pos):
        x, y = pos[0], pos[1]
        dyx = y - x * x
        gx = 2.0 * (a - x) + 4.0 * b * x * dyx
        gy = -2.0 * b * dyx
        return jnp.stack([gx, gy])

    return Target(logp=logp, logp_batch=logp_batch, grad=grad)


def rosenbrock_nd() -> Target:
    """N-D Rosenbrock: ``logp = -sum_i [100*(x_{i+1} - x_i^2)^2 + (1 - x_i)^2]``.

    Fixed coefficients (100, 1) per the reference's ``RosenbrockND``
    (/root/reference/src/distributions.rs:530-547).
    """

    def logp(pos):
        low = pos[:-1]
        high = pos[1:]
        term_1 = 100.0 * (high - low * low) ** 2
        term_2 = (1.0 - low) ** 2
        return -jnp.sum(term_1 + term_2)

    def logp_batch(positions):
        low = positions[:, :-1]
        high = positions[:, 1:]
        term_1 = 100.0 * (high - low * low) ** 2
        term_2 = (1.0 - low) ** 2
        return -jnp.sum(term_1 + term_2, axis=-1)

    def grad(pos):
        low = pos[:-1]
        high = pos[1:]
        d = high - low * low
        g = jnp.zeros_like(pos)
        # d/d low: -[100 * 2 * d * (-2 low) + 2 (low - 1)]
        g = g.at[:-1].add(400.0 * d * low + 2.0 * (1.0 - low))
        # d/d high: -[200 * d]
        g = g.at[1:].add(-200.0 * d)
        return g

    def logp_dc(pos_dc):
        # chains-on-lanes layout [D, C] -> [C]
        low = pos_dc[:-1]
        high = pos_dc[1:]
        term_1 = 100.0 * (high - low * low) ** 2
        term_2 = (1.0 - low) ** 2
        return -jnp.sum(term_1 + term_2, axis=0)

    def grad_dc(pos_dc):
        # concat-based: two shifted adds instead of a scatter-add
        low = pos_dc[:-1]
        high = pos_dc[1:]
        d = high - low * low
        zero = jnp.zeros_like(pos_dc[:1])
        low_contrib = 400.0 * d * low + 2.0 * (1.0 - low)
        high_contrib = -200.0 * d
        return (
            jnp.concatenate([low_contrib, zero], axis=0)
            + jnp.concatenate([zero, high_contrib], axis=0)
        )

    return Target(logp=logp, logp_batch=logp_batch, grad=grad,
                  logp_dc=logp_dc, grad_dc=grad_dc)
