"""Dual-averaging step-size adaptation for fixed-trajectory samplers.

The reference adapts the step size only inside NUTS (Hoffman & Gelman
Algorithm 6 constants at /root/reference/src/nuts.rs:425-430); its HMC takes
a hand-tuned ``step_size`` forever. This module factors that dual-averaging
update out of the NUTS step so HMC and MALA can warm up the same way —
beyond-reference, but with the reference's exact constants (GAMMA, T_0,
KAPPA re-used from ``ops/nuts.py``) so the two adaptation paths stay
comparable.

Shape: the whole warmup is ONE ``lax.scan`` over the adaptation steps —
the per-step acceptance statistic is a cross-chain mean (a scalar), so the
carried adaptation state is 3 scalars and the program compiles once for a
given ``n_adapt``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .nuts import GAMMA, KAPPA, T_0


def dual_average_step_size(
    step_eps,
    state,
    key: jax.Array,
    n_adapt: int,
    eps0: float,
    target_accept: float,
):
    """Warm up ``eps`` by dual averaging over ``n_adapt`` sampler steps.

    ``step_eps(state, key, eps) -> (state, mean_alpha)`` advances one
    sampler step at a TRACED step size and returns the cross-chain mean
    Metropolis acceptance probability (NaN-divergent proposals counted as
    0). The update is Hoffman & Gelman's Algorithm 6 with the reference's
    constants (mu = ln(10 eps0), h_bar = 0, log_eps_bar = 0,
    nuts.rs:425-430, :676-691): shrink toward ``mu`` while the running
    acceptance deficit ``h_bar`` is positive, and average the iterates with
    weight ``m^-kappa``.

    Returns ``(state, eps_tuned, mean_alpha_trace [n_adapt])`` — the state
    after the adaptation leg, the averaged step size ``exp(log_eps_bar)``,
    and the per-step acceptance trace (for diagnostics/tests).
    """
    if n_adapt < 1:
        raise ValueError(f"n_adapt must be >= 1, got {n_adapt}")
    dt = jnp.result_type(float)  # honors jax_enable_x64
    mu = jnp.log(jnp.asarray(10.0 * eps0, dt))
    log_eps0 = jnp.log(jnp.asarray(eps0, dt))

    def body(carry, m):
        state, log_eps, log_eps_bar, h_bar = carry
        sub = jax.random.fold_in(key, m)
        state, alpha = step_eps(state, sub, jnp.exp(log_eps))
        m_f = m.astype(dt)
        frac = 1.0 / (m_f + T_0)
        deficit = target_accept - alpha.astype(dt)
        h_bar = (1.0 - frac) * h_bar + frac * deficit
        log_eps = mu - jnp.sqrt(m_f) / GAMMA * h_bar
        w = m_f ** (-KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        return (state, log_eps, log_eps_bar, h_bar), alpha

    (state, _, log_eps_bar, _), alphas = lax.scan(
        body,
        (state, log_eps0, jnp.zeros((), dt), jnp.zeros((), dt)),
        jnp.arange(1, n_adapt + 1),
    )
    return state, float(jnp.exp(log_eps_bar)), alphas
