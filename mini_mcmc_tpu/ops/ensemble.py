"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move).

Beyond-reference capability (the Rust reference has no ensemble sampler):
the gradient-free workhorse popularized by ``emcee`` (Foreman-Mackey et al.
2013), here in its batched form. The complementary-ensemble ("red-black")
update is embarrassingly batchable: each ensemble's walkers are split into
two fixed halves, and every walker in the active half moves simultaneously
against a random partner from the other half —

    y_i = x_j + z * (x_i - x_j),   z ~ g(z) ∝ 1/sqrt(z) on [1/a, a],
    accept with log prob  min(0, (D-1) ln z + logp(y_i) - logp(x_i)).

Updating a whole half in lockstep preserves detailed balance because the
walkers of one half are conditionally independent given the other half
(Foreman-Mackey et al. 2013, §3). All ensembles advance in one ``[C, D]``
batch: two fused target evaluations per sweep, no per-walker loops.

The sampler is affine-equivariant by construction: mapping the target and
the initial positions through any invertible affine map maps the whole
trajectory through it (pinned by ``tests/test_ensemble.py``), which is what
makes it insensitive to scale/correlation pathologies that cripple
isotropic-proposal MH.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.base import Target
from ..runner import make_scan_block_fn


class EnsembleState(NamedTuple):
    positions: jax.Array  # [C, D], C = n_ensembles * walkers_per_ensemble
    logp: jax.Array  # [C] cached unnormalized target log density


def ensemble_kernel(target: Target, *, walkers_per_ensemble: int,
                    a: float = 2.0, steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for the batched stretch move.

    ``init_fn(positions [C, D]) -> EnsembleState`` (``C`` must be a
    multiple of ``walkers_per_ensemble``, which must be even, >= 4, and
    >= D+2 — fewer walkers confine the stretch move to a proper affine
    subspace, checked at init; use >= 2*D per ensemble for healthy
    mixing, the emcee rule of thumb). One ``step_fn`` call is a full sweep: both halves of every
    ensemble update once. Partner draws never cross ensemble boundaries,
    so distinct ensembles are independent chains-of-ensembles (shard the
    chain axis at ensemble granularity).

    ``a``: stretch scale (> 1). ``steps_per_call`` > 1 attaches the K-sweep
    block function (same contract as the MH/HMC block kernels).
    """
    w = walkers_per_ensemble
    if w < 4 or w % 2 != 0:
        raise ValueError(
            f"walkers_per_ensemble must be even and >= 4, got {w}"
        )
    if not a > 1.0:
        raise ValueError(f"stretch scale a must be > 1, got {a}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    half = w // 2

    def init_fn(positions: jax.Array) -> EnsembleState:
        c = positions.shape[0]
        if c % w != 0:
            raise ValueError(
                f"n_chains={c} must be a multiple of "
                f"walkers_per_ensemble={w}"
            )
        d = positions.shape[1]
        if w < d + 2:
            # Stretch proposals stay inside the ensemble's affine hull,
            # and the hull never grows — w walkers span at most a
            # (w-1)-dim slice, so a small ensemble on a high-D target is
            # silently non-ergodic (healthy-looking within-slice
            # diagnostics, wrong posterior). Hard error, not a warning.
            raise ValueError(
                f"walkers_per_ensemble={w} cannot ergodically sample a "
                f"{d}-D target: the stretch move is confined to the "
                f"ensemble's affine hull (dim <= {w - 1}); need at least "
                f"D+2 = {d + 2} walkers per ensemble, ideally >= 2*D"
            )
        return EnsembleState(
            positions=positions, logp=target.batch_logp(positions)
        )

    def _half_update(key, active, active_lp, other):
        """Move ``active`` [E, half, D] against partners from ``other``."""
        e, h, d = active.shape
        k_j, k_z, k_u = jax.random.split(key, 3)
        j = jax.random.randint(k_j, (e, h), 0, h)
        partners = jnp.take_along_axis(other, j[:, :, None], axis=1)
        # Inverse-CDF draw from g(z) ∝ 1/sqrt(z) on [1/a, a].
        u = jax.random.uniform(k_z, (e, h), active.dtype)
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        proposed = partners + z[:, :, None] * (active - partners)
        prop_lp = target.batch_logp(proposed.reshape(e * h, d)).reshape(e, h)
        log_accept = (d - 1.0) * jnp.log(z) + prop_lp - active_lp
        lnu = jnp.log(jax.random.uniform(k_u, (e, h), log_accept.dtype))
        accept = log_accept > lnu
        return (
            jnp.where(accept[:, :, None], proposed, active),
            jnp.where(accept, prop_lp, active_lp),
        )

    def step_fn(state: EnsembleState, key: jax.Array) -> EnsembleState:
        c, d = state.positions.shape
        e = c // w
        pos = state.positions.reshape(e, w, d)
        lp = state.logp.reshape(e, w)
        k1, k2 = jax.random.split(key)
        first, lp_first = _half_update(
            k1, pos[:, :half], lp[:, :half], pos[:, half:]
        )
        second, lp_second = _half_update(
            k2, pos[:, half:], lp[:, half:], first
        )
        return EnsembleState(
            positions=jnp.concatenate([first, second], axis=1).reshape(c, d),
            logp=jnp.concatenate([lp_first, lp_second], axis=1).reshape(c),
        )

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
