"""Chain runner: lax.scan over vmapped step kernels.

Batched replacement for the reference's ``ChainRunner`` layer
(/root/reference/src/core.rs:145-366). Where the reference fans chains out
over Rayon threads and stacks per-chain ``Array2`` results, here every
sampler step already advances all chains as one batched tensor, so "running
chains in parallel" is a single ``lax.scan`` over steps compiled by XLA; the
canonical output keeps the reference's ``[n_chains, n_collect, dim]``
contract (/root/reference/src/core.rs:173-186).

Memory: the burn-in phase is a separate (output-free) scan inside the same
compiled program, so device memory for recording is O(n_collect), matching
the reference's allocation of only the collected rows (core.rs:55-73) —
not O(n_collect + n_discard).

Multi-chip: pass sharded ``state`` (chains axis over a mesh); chains are
independent, so XLA's SPMD partitioner runs the same compiled loop per shard
with no communication (see ``mini_mcmc_tpu.parallel``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax


def _default_positions_of(state):
    return state.positions


def _make_phases(step_fn, positions_of, tracker_update):
    """Shared discard/collect scan phases."""

    def discard_phase(state, tracker, key, n_discard: int):
        if n_discard == 0:
            return state, tracker

        def body(carry, step_key):
            state, tracker = carry
            state = step_fn(state, step_key)
            if tracker_update is not None and tracker is not None:
                tracker = tracker_update(tracker, positions_of(state))
            return (state, tracker), None

        step_keys = jax.random.split(key, n_discard)
        (state, tracker), _ = lax.scan(body, (state, tracker), step_keys)
        return state, tracker

    def collect_phase(state, tracker, key, n_collect: int):
        def body(carry, step_key):
            state, tracker = carry
            state = step_fn(state, step_key)
            if tracker_update is not None and tracker is not None:
                tracker = tracker_update(tracker, positions_of(state))
            return (state, tracker), positions_of(state)

        step_keys = jax.random.split(key, n_collect)
        (state, tracker), ys = lax.scan(body, (state, tracker), step_keys)
        return state, tracker, ys  # ys: [n_collect, C, D]

    return discard_phase, collect_phase


def make_simple_runner(
    step_fn: Callable,
    positions_of: Callable = _default_positions_of,
    tracker_update: Optional[Callable] = None,
):
    """Compile a runner with the MH/Gibbs/HMC collection convention.

    ``run(state, key, n_collect, n_discard, tracker=None)`` takes
    ``n_collect + n_discard`` steps and records the last ``n_collect``
    states as ``[C, n_collect, D]`` (/root/reference/src/core.rs:55-73,
    /root/reference/src/hmc.rs:137-157).

    Args:
        step_fn: ``(state, key) -> state``; state carries ``[C, D]`` positions.
        positions_of: extracts the ``[C, D]`` positions to record.
        tracker_update: optional ``(tracker, positions) -> tracker`` streaming
            statistics update threaded through the scan (the on-device analog
            of ``ChainTracker::step``, /root/reference/src/stats.rs:89-126).

    Returns ``(final_state, sample, tracker)``. Samples are stacked
    ``[steps, C, D]`` inside the scan (contiguous per-step writes) and
    transposed once at the end, instead of strided ``[C, steps, D]``
    scatters every step. ``time_major=True`` skips that final transpose and
    returns ``[steps, C, D]`` — the transpose materializes a second sample
    cube, so skipping it halves peak HBM at huge chain counts (consume
    with ``split_rhat_mean_ess(..., time_major=True)``).
    """
    discard_phase, collect_phase = _make_phases(
        step_fn, positions_of, tracker_update
    )

    @partial(
        jax.jit,
        static_argnames=("n_collect", "n_discard", "time_major"),
        donate_argnames=("state",),
    )
    def run(state, key, n_collect: int, n_discard: int, tracker=None,
            time_major: bool = False):
        key_discard, key_collect = jax.random.split(key)
        state, tracker = discard_phase(state, tracker, key_discard, n_discard)
        state, tracker, ys = collect_phase(state, tracker, key_collect,
                                           n_collect)
        sample = ys if time_major else jnp.swapaxes(ys, 0, 1)
        return state, sample, tracker

    return run


def make_scan_block_fn(step_fn: Callable, k: int) -> Callable:
    """K-step block kernel: K scanned ``step_fn`` steps per call,
    returning ``(state, rows [K, C, D])`` — the contract
    :func:`make_block_runner` consumes.
    """

    def block_fn(state, key):
        def body(carry, sub):
            carry = step_fn(carry, sub)
            return carry, carry.positions

        return lax.scan(body, state, jax.random.split(key, k))

    return block_fn


def make_block_runner(
    block_fn: Callable,
    block_size: int,
    tracker_update: Optional[Callable] = None,
):
    """Compile a runner over K-step block kernels (same collection
    convention as :func:`make_simple_runner`).

    ``block_fn(state, key) -> (state, rows [K, C, D])`` advances K sampler
    steps per call and returns every intermediate position
    (:func:`make_scan_block_fn`), so the sample cube is identical in
    meaning to the per-step runner's — recording is NOT thinned.
    ``n_collect`` and ``n_discard`` must be multiples of ``block_size``.
    """
    k = block_size

    def _update_tracker(tracker, rows):
        if tracker_update is None or tracker is None:
            return tracker
        for i in range(k):  # static unroll; tracker folds row-by-row
            tracker = tracker_update(tracker, rows[i])
        return tracker

    def discard_phase(state, tracker, key, n_discard: int):
        if n_discard == 0:
            return state, tracker

        def body(carry, block_key):
            state, tracker = carry
            state, rows = block_fn(state, block_key)
            return (state, _update_tracker(tracker, rows)), None

        block_keys = jax.random.split(key, n_discard // k)
        (state, tracker), _ = lax.scan(body, (state, tracker), block_keys)
        return state, tracker

    def collect_phase(state, tracker, key, n_collect: int):
        def body(carry, block_key):
            state, tracker = carry
            state, rows = block_fn(state, block_key)
            return (state, _update_tracker(tracker, rows)), rows

        block_keys = jax.random.split(key, n_collect // k)
        (state, tracker), ys = lax.scan(body, (state, tracker), block_keys)
        return state, tracker, ys  # [blocks, K, C, D]

    @partial(
        jax.jit,
        static_argnames=("n_collect", "n_discard", "time_major"),
        donate_argnames=("state",),
    )
    def run(state, key, n_collect: int, n_discard: int, tracker=None,
            time_major: bool = False):
        if n_collect % k or n_discard % k:
            raise ValueError(
                f"n_collect={n_collect} and n_discard={n_discard} must be "
                f"multiples of the block size {k}"
            )
        key_discard, key_collect = jax.random.split(key)
        state, tracker = discard_phase(state, tracker, key_discard, n_discard)
        state, tracker, ys = collect_phase(state, tracker, key_collect,
                                           n_collect)
        # [blocks, K, C, D] -> [n_collect, C, D] (-> [C, n_collect, D])
        rows = ys.reshape((-1,) + ys.shape[2:])
        sample = rows if time_major else jnp.swapaxes(rows, 0, 1)
        return state, sample, tracker

    return run


def make_initial_recording_runner(
    step_fn: Callable,
    positions_of: Callable = _default_positions_of,
    tracker_update: Optional[Callable] = None,
):
    """Compile a runner with the NUTS collection convention
    (/root/reference/src/nuts.rs:457-470).

    Row 0 of the sample is the position at the start of collection (the
    initial position when ``n_discard == 0``); ``n_collect + n_discard - 1``
    steps are taken in total, and rows follow the reference's overwrite
    semantics (row i = state after step ``n_discard + i`` for
    ``n_discard > 0``).
    """
    discard_phase, collect_phase = _make_phases(
        step_fn, positions_of, tracker_update
    )

    @partial(
        jax.jit,
        static_argnames=("n_collect", "n_discard", "time_major"),
        donate_argnames=("state",),
    )
    def run(state, key, n_collect: int, n_discard: int, tracker=None,
            time_major: bool = False):
        key_discard, key_collect = jax.random.split(key)
        if n_discard == 0:
            first = positions_of(state)
            state, tracker, ys = collect_phase(
                state, tracker, key_collect, n_collect - 1
            )
            rows = jnp.concatenate([first[None], ys], axis=0)
        else:
            # n_discard - 1 unrecorded steps, then n_collect recorded ones
            # (row 0 = state after step n_discard, nuts.rs:463-468).
            state, tracker = discard_phase(
                state, tracker, key_discard, n_discard - 1
            )
            state, tracker, rows = collect_phase(
                state, tracker, key_collect, n_collect
            )
        sample = rows if time_major else jnp.swapaxes(rows, 0, 1)
        return state, sample, tracker

    return run
