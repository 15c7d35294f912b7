"""Vectorized Metropolis-Hastings step kernel.

Batched redesign of the reference's per-chain scalar loop
(``MHMarkovChain::step``, /root/reference/src/metropolis_hastings.rs:303-315):
all chains advance in lockstep as a ``[n_chains, D]`` batch; propose, evaluate
target and proposal log densities, and accept with a masked ``where`` instead
of a branch. Integer state dtypes are supported for discrete targets
(/root/reference/src/lib.rs:153-209).

The current target log density is cached in the state, halving target
evaluations per step relative to the reference's recompute (numerically
identical: the cache is exactly the previous evaluation).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.base import Proposal, Target
from ..runner import make_scan_block_fn


class MHState(NamedTuple):
    positions: jax.Array  # [n_chains, D] (float or integer dtype)
    logp: jax.Array  # [n_chains] cached unnormalized target log density


def _mh_step(target: Target, proposal: Proposal, state: MHState,
                 key: jax.Array):
    """One batched MH update; returns ``(MHState, log_accept [C])``.

    Shared between the sampling step (which discards ``log_accept``) and
    the proposal-scale adaptation hook (:func:`mh_step_alpha`, which turns
    it into a mean acceptance probability)."""
    n_chains = state.positions.shape[0]
    key_prop, key_u = jax.random.split(key)

    if proposal.sample_batch is not None:
        proposed = proposal.sample_batch(key_prop, state.positions)
    else:
        prop_keys = jax.random.split(key_prop, n_chains)
        proposed = jax.vmap(proposal.sample)(prop_keys, state.positions)
    proposed_lp = target.batch_logp(proposed)
    log_q_fwd = jax.vmap(proposal.logp)(state.positions, proposed)
    log_q_bwd = jax.vmap(proposal.logp)(proposed, state.positions)

    # log alpha = (logp' + logq_back) - (logp + logq_fwd); accept iff
    # log alpha > ln(u)  (metropolis_hastings.rs:309-313).
    log_accept = (proposed_lp + log_q_bwd) - (state.logp + log_q_fwd)
    u = jax.random.uniform(key_u, (n_chains,), log_accept.dtype)
    accept = log_accept > jnp.log(u)

    positions = jnp.where(accept[:, None], proposed, state.positions)
    logp = jnp.where(accept, proposed_lp, state.logp)
    return MHState(positions=positions, logp=logp), log_accept


def mh_step_alpha(target: Target, proposal_family):
    """Adaptation hook for dual-averaging the proposal scale.

    ``proposal_family(factor) -> Proposal`` builds the proposal at a TRACED
    scale factor (``Proposal.scaled``). Returns ``step_eps(state, key,
    factor) -> (MHState, mean_alpha)`` in the shape
    ``ops/adapt.dual_average_step_size`` expects, where ``mean_alpha`` is
    the cross-chain mean Metropolis acceptance probability
    ``min(1, exp(log_accept))`` with NaN-divergent proposals counted as 0.
    """

    def step_eps(state: MHState, key: jax.Array, factor):
        # cast: the dual-averaging iterate is float64 under jax_enable_x64;
        # an f64 factor would promote the proposed positions and break the
        # scan carry dtype when the chain state is f32
        proposal = proposal_family(
            jnp.asarray(factor, state.positions.dtype)
        )
        state, log_accept = _mh_step(target, proposal, state, key)
        alpha = jnp.minimum(1.0, jnp.exp(log_accept))
        alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
        return state, jnp.mean(alpha)

    return step_eps


def mh_kernel(target: Target, proposal: Proposal, *,
              steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for batched MH.

    ``init_fn(positions [C, D]) -> MHState``
    ``step_fn(state, key) -> MHState``

    ``steps_per_call`` > 1 additionally attaches a K-step block function
    (``step_fn.block_fn``/``block_size``) that scans K full updates per
    call (``runner.make_scan_block_fn``). All recorded positions are kept;
    nothing is thinned.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")

    def init_fn(positions: jax.Array) -> MHState:
        return MHState(positions=positions, logp=target.batch_logp(positions))

    def step_fn(state: MHState, key: jax.Array) -> MHState:
        state, _ = _mh_step(target, proposal, state, key)
        return state

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
