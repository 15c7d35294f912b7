"""Batched Gibbs sweep kernel.

Batched redesign of ``GibbsMarkovChain::step``
(/root/reference/src/gibbs.rs:95-99): one step = a full coordinate sweep,
``state[i] = conditional(key, i, state)`` for i = 0..D-1, expressed as a
``lax.fori_loop`` inside the batched step so all chains sweep in lockstep.
The coordinate sweep is inherently sequential (each coordinate conditions on
the freshly updated state), so the loop is over D, not chains; chains are the
vectorized axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.base import Conditional
from ..runner import make_scan_block_fn


class GibbsState(NamedTuple):
    positions: jax.Array  # [C, D]


def gibbs_kernel(conditional: Conditional, *, steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for a batched Gibbs sweep.

    ``init_fn(positions [C, D]) -> GibbsState``
    ``step_fn(state, key) -> GibbsState``

    ``steps_per_call`` > 1 additionally attaches a K-sweep block function
    (``step_fn.block_fn``/``block_size``) that scans K full sweeps per
    call (``runner.make_scan_block_fn``). All recorded positions are kept;
    nothing is thinned.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")

    def init_fn(positions: jax.Array) -> GibbsState:
        return GibbsState(positions=jnp.asarray(positions))

    def sweep_one_chain(key, state_row):
        dim = state_row.shape[0]
        coord_keys = jax.random.split(key, dim)

        def body(i, row):
            value = conditional.sample(coord_keys[i], i, row)
            return row.at[i].set(value)

        return lax.fori_loop(0, dim, body, state_row)

    def step_fn(state: GibbsState, key: jax.Array) -> GibbsState:
        n_chains, dim = state.positions.shape
        if conditional.sample_batch is not None:
            # batched sweep: one key per coordinate, tensor ops over chains
            coord_keys = jax.random.split(key, dim)

            def body(i, positions):
                values = conditional.sample_batch(coord_keys[i], i, positions)
                return positions.at[:, i].set(values)

            positions = lax.fori_loop(0, dim, body, state.positions)
            return GibbsState(positions=positions)

        chain_step_keys = jax.random.split(key, n_chains)
        positions = jax.vmap(sweep_one_chain)(chain_step_keys, state.positions)
        return GibbsState(positions=positions)

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
