"""Streaming chunked runs: bounded-memory production sampling.

``run()`` materializes the whole sample cube; a multi-million-draw
production run wants the draws on disk, not in HBM/host RAM. This module
runs the sampler in fixed-size chunks, hands each chunk to a consumer
(e.g. :class:`~mini_mcmc_tpu.io.parquet_io.ParquetStreamWriter`) while
the device advances the next one, and threads the on-device streaming
tracker (``stats.tracker_*`` — the reference's ``ChainTracker`` analog,
/root/reference/src/stats.rs:26-141) across chunks, so acceptance and
live R-hat cover the WHOLE run even though no full cube ever exists.

Chunks default to time-major ``[k, C, D]`` (the scan-native layout —
no per-chunk transpose, and the chunk-concatenation order is exactly
the observation-major Parquet tensor schema's row order). All chunks
share one compiled program signature (one remote compile; the first
chunk's discard phase is a second signature).
"""

from __future__ import annotations

import dataclasses

import jax

from . import stats as stats_mod


@dataclasses.dataclass
class StreamResult:
    """End-of-stream summary from the streaming tracker (no cube).

    ``p_accept``: the global EWMA acceptance scalar (folds across chains
    per the reference's tracker semantics, stats.rs:110-123); ``rhat``:
    live (streaming-moment) R-hat per parameter ``[P]`` — the tracker
    quantity, not split-R-hat (no full series exists to split).
    """

    n_collected: int
    p_accept: jax.Array
    rhat: jax.Array

    def __str__(self) -> str:
        import jax.numpy as jnp

        return (
            f"streamed {self.n_collected} draws/chain: "
            f"p(accept) mean {float(jnp.mean(self.p_accept)):.3f}, "
            f"live R-hat max {float(jnp.max(self.rhat)):.4f}"
        )


def stream_run(sampler, n_total: int, chunk_size: int, on_chunk=None,
               n_discard: int = 0, *, time_major: bool = True
               ) -> StreamResult:
    """Advance ``n_discard + n_total`` steps, delivering the collected
    draws in ``n_total / chunk_size`` chunks instead of one cube.

    Args:
        sampler: any sampler object from this package (the state pytree
            advances in place, so consecutive ``stream_run``/``run``
            calls continue the chains).
        n_total: total draws per chain; must be a multiple of
            ``chunk_size`` (one compiled signature for every chunk).
        chunk_size: draws per chunk — the peak host-side allocation is
            one ``[chunk_size, C, D]`` array.
        on_chunk: optional ``(chunk, start) -> None`` consumer called
            with each chunk and its global first-observation index;
            e.g. ``ParquetStreamWriter.append``.
        n_discard: warmup steps before the first chunk.
        time_major: chunk layout ``[k, C, D]`` (default) or ``[C, k, D]``.

    Returns:
        :class:`StreamResult` with whole-run streaming diagnostics.
    """
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if n_total % chunk_size != 0:
        raise ValueError(
            f"n_total={n_total} must be a multiple of chunk_size="
            f"{chunk_size} (one compiled program signature per chunk)"
        )
    block = getattr(sampler, "_progress_block_size", 1)
    if chunk_size % block != 0 or n_discard % block != 0:
        raise ValueError(
            f"chunk_size={chunk_size} and n_discard={n_discard} must be "
            f"multiples of the sampler's block size {block}"
        )
    # NUTS: run its prepare pass (step-size search + adaptation schedule)
    # once up front, snapshot divergences so last_run_divergences covers
    # the stream, and stream through its SIMPLE runner — the
    # initial-recording convention would re-record the then-current
    # position as row 0 of every chunk, duplicating draws at chunk
    # boundaries. Like run_progress's chunked path (nuts.py), the simple
    # runner then takes n_discard - 1 warmup steps (the NUTS convention
    # is n_collect + n_discard - 1 total steps).
    snapshot = getattr(sampler, "_snapshot_divergences", None)
    if snapshot is not None:
        snapshot()
    first_discard = n_discard
    prepare = getattr(sampler, "_prepare_fn", None)
    if prepare is not None:
        sampler.state = prepare(
            sampler.state, sampler._next_key(), n_discard=n_discard
        )
        first_discard = max(0, n_discard - 1)
    runner = getattr(sampler, "_simple_runner", None) or sampler._runner
    tracker = stats_mod.tracker_init(sampler.n_chains, sampler.dim)
    # One-chunk pipeline: dispatch chunk i (async under JAX), then hand
    # chunk i-1 to the consumer while the device computes — disk writes
    # overlap device time; peak host memory stays at ~two chunks.
    pending = None
    for i in range(n_total // chunk_size):
        sampler.state, chunk, tracker = runner(
            sampler.state,
            sampler._next_key(),
            chunk_size,
            first_discard if i == 0 else 0,
            tracker=tracker,
            time_major=time_major,
        )
        if on_chunk is not None:
            if pending is not None:
                on_chunk(*pending)
            pending = (chunk, i * chunk_size)
    if pending is not None:
        on_chunk(*pending)
    return StreamResult(
        n_collected=n_total,
        p_accept=stats_mod.tracker_stats(tracker).p_accept,
        rhat=stats_mod.tracker_rhat(tracker),
    )
