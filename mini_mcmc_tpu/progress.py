"""Live progress reporting for sampling runs.

Batched replacement for the reference's progress system
(/root/reference/src/core.rs:208-360: per-chain worker threads, mpsc
channels, a detached progress thread driving indicatif bars). The display
matches the reference's layout — one global bar plus up to five rotating
per-chain bars showing each chain's ``p(accept)`` EWMA
(core.rs:243-283) — with one semantic change forced by the execution
model: here all chains advance in lockstep inside one compiled scan, so
the reference's finish-rotation (a chain's bar is replaced by the next
chain index when that chain completes, core.rs:301-317) would degenerate
to a single end-of-run swap. Rotation here advances on the worker-side
stats tick instead, so a long run still cycles through every chain's
statistics like the reference's display does.

Implementation: the run is chunked into several compiled scans; between
chunks the tiny tracker summary is fetched to the host and the bar block
is redrawn on stderr. This replaces mpsc channels with the device->host
transfer at the reference's throttled cadence: stats are fetched at most
once per second (the worker-side throttle, core.rs:105) and the screen is
redrawn at most every 250 ms (the UI-side throttle, core.rs:230).
"""

from __future__ import annotations

import sys
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import stats as stats_mod

#: worker-side throttle: min seconds between device->host stats fetches
#: (the analog of the reference chains' 1 s send throttle, core.rs:105)
_STATS_SECONDS = 1.0
#: UI-side throttle: min seconds between screen redraws (core.rs:230)
_REFRESH_SECONDS = 0.25
#: concurrent per-chain bars (core.rs:244: ``rxs.len().min(5)``)
_MAX_CHAIN_BARS = 5
#: target number of chunks per run (more chunks = fresher stats, more
#: dispatch overhead)
_TARGET_CHUNKS = 20


def _bar(done: int, total: int, width: int = 30) -> str:
    frac = done / max(total, 1)
    filled = int(width * frac)
    return "=" * filled + ">" + "-" * (width - filled - 1) \
        if filled < width else "=" * width


class _ProgressDisplay:
    """Global + rotating per-chain bar block (core.rs:236-324 layout)."""

    def __init__(self, n_chains: int, total: int, stream):
        self.n_chains = n_chains
        self.total = total
        self.stream = stream
        self.active = list(range(min(n_chains, _MAX_CHAIN_BARS)))
        self.next_active = len(self.active)
        self._prev_lines = 0
        self._isatty = bool(getattr(stream, "isatty", lambda: False)())

    def rotate(self) -> None:
        """Advance one displayed chain to the next undisplayed index.

        The reference rotates a bar when its chain finishes
        (core.rs:301-317); chains here finish simultaneously, so rotation
        rides the stats tick instead. Like the reference, every chain is
        shown at most once, then rotation stops.
        """
        if self.next_active < self.n_chains:
            self.active = self.active[1:] + [self.next_active]
            self.next_active += 1

    def render(self, done: int, p_accept: float, p_accept_chains,
               max_rhat: float, elapsed: float) -> None:
        lines = [
            f"Global   [{_bar(done, self.total)}] {done}/{self.total} "
            f"({elapsed:.1f}s) | p(accept)≈{p_accept:.2f} "
            f"max(rhat)≈{max_rhat:.2f}"
        ]
        for idx in self.active:
            lines.append(
                f"Chain {idx:<2} [{_bar(done, self.total)}] "
                f"{done}/{self.total} | "
                f"p(accept)≈{float(p_accept_chains[idx]):.2f}"
            )
        if self._isatty and self._prev_lines:
            # move to the start of the previous block and overwrite
            self.stream.write(f"\x1b[{self._prev_lines}F")
            lines = [ln + "\x1b[K" for ln in lines]
        self.stream.write("\n".join(lines) + "\n")
        self.stream.flush()
        self._prev_lines = len(lines)


def progress_run(
    runner: Callable,
    state,
    key: jax.Array,
    n_collect: int,
    n_discard: int,
    *,
    n_chains: int,
    dim: int,
    stream=None,
    time_major: bool = False,
    block_size: int = 1,
    tail_runner: Callable = None,
    initial_rows=None,
):
    """Run ``runner`` in chunks with a live progress bar block.

    ``runner`` is a compiled runner from :mod:`mini_mcmc_tpu.runner` taking
    ``(state, key, n_collect, n_discard, tracker)``. Returns
    ``(final_state, sample [C, n_collect, D])`` — time-major
    ``[n_collect, C, D]`` with ``time_major=True``.

    Scale behavior: collected chunks are written into
    ONE preallocated sample cube with a buffer-donating
    ``dynamic_update_slice`` (never a host-side concatenate, which would
    double peak HBM at flagship chain counts), and ``block_size`` > 1
    drives a block runner (K-step block kernels) for the K-aligned bulk of
    every chunk, with ``tail_runner`` (per-step convention) covering the
    sub-K remainder — so live-monitored runs keep the same
    memory/throughput envelope as headless ones.

    ``initial_rows``: optional ``[r0, C, D]`` rows recorded before the
    first step (the NUTS initial-recording convention) — they fill the
    start of the cube and count toward ``n_collect``.
    """
    from functools import partial

    from jax import lax

    stream = stream if stream is not None else sys.stderr
    k = max(1, block_size)
    tail_runner = tail_runner if tail_runner is not None else runner
    n_initial = 0 if initial_rows is None else int(initial_rows.shape[0])
    total = n_collect + n_discard - n_initial
    chunk = max(k, (max(1, total) // _TARGET_CHUNKS) // k * k)
    # Prefer a k-multiple chunk that divides the total exactly: every chunk
    # then shares ONE compiled signature. Each extra signature of the big
    # scan programs is a fresh compile, so a degrading-remainder schedule
    # (chunk, ..., smaller, tail) costs more in compiles than it saves in
    # freshness.
    for cand in range(chunk, 2 * chunk + 1, k):
        if cand > 0 and total % cand == 0:
            chunk = cand
            break

    tracker = stats_mod.tracker_init(n_chains, dim)
    display = _ProgressDisplay(n_chains, total + n_initial, stream)
    dtype = getattr(getattr(state, "positions", None), "dtype", jnp.float32)

    # One preallocated cube; chunks land via donated in-place updates.
    cube_shape = (
        (n_collect, n_chains, dim) if time_major
        else (n_chains, n_collect, dim)
    )
    cube = jnp.zeros(cube_shape, dtype)

    @partial(jax.jit, donate_argnums=(0,), static_argnames=())
    def insert(buf, piece, off):
        start = (off, 0, 0) if time_major else (0, off, 0)
        return lax.dynamic_update_slice(buf, piece, start)

    n_kept = 0
    if n_initial:
        rows = initial_rows if time_major else jnp.swapaxes(
            initial_rows, 0, 1)
        cube = insert(cube, rows, 0)
        n_kept = n_initial

    done = 0
    start_t = time.monotonic()
    last_render = 0.0
    last_stats = 0.0
    stats = None  # (p_accept, p_accept_chains, max_rhat)

    # Every chunk uses the collect-only signature (c, 0) so the whole
    # progress run compiles at most three programs (full chunk + K-aligned
    # remainder + sub-K tail); burn-in rows are simply dropped device-side.
    # Varying (c, d) chunk signatures would recompile the entire sampling
    # scan per combination.
    remaining = total
    while remaining > 0:
        c = min(chunk, remaining // k * k)
        drive = runner
        if c == 0:  # sub-K tail: per-step convention
            c, drive = remaining, tail_runner
        key, sub = jax.random.split(key)
        state, sample, tracker = drive(
            state, sub, c, 0, tracker=tracker, time_major=time_major
        )
        keep_from = max(0, n_discard - done)
        if keep_from < c:
            piece = (
                sample[keep_from:] if time_major
                else sample[:, keep_from:]
            )
            cube = insert(cube, piece, n_kept)
            n_kept += c - keep_from
        remaining -= c
        done += c

        now = time.monotonic()
        final = done >= total
        if stats is None or now - last_stats >= _STATS_SECONDS or final:
            # worker-side tick: fetch stats to the host, rotate the bars.
            # Materialize the per-chain vector to host memory HERE — the
            # renderer indexes it per bar per redraw, and indexing a device
            # array would dispatch a device-to-host transfer per bar per
            # frame, defeating this throttle.
            p_accept = float(tracker.p_accept)
            pc = np.asarray(tracker.p_accept_chains)
            max_rhat = float(stats_mod.tracker_max_rhat(tracker))
            if stats is not None:
                display.rotate()
            stats = (p_accept, pc, max_rhat)
            last_stats = now
        if now - last_render >= _REFRESH_SECONDS or final:
            display.render(done + n_initial, stats[0], stats[1], stats[2],
                           now - start_t)
            last_render = now

    stream.flush()
    return state, cube
