"""Profiling helpers.

The reference's tracing surface is the wall-clock ``Timer``
(/root/reference/src/dev_tools.rs); the equivalents here are XLA profiler
traces (tensorboard-compatible) plus a step timer that understands async
dispatch.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` trace around a block.

    View with TensorBoard (or xprof) pointed at ``log_dir``.

        with profiling.trace("trace_out"):
            sampler.run(1000, 100)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def step_timer(fn, *args, repeats: int = 3, **kwargs):
    """Median wall-clock of ``fn(*args, **kwargs)``, each call timed until
    ``jax.block_until_ready`` returns (async dispatch safe). Returns
    ``(result, seconds)``."""
    times = []
    result = None
    for _ in range(repeats):
        t0 = time.monotonic()
        result = jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.monotonic() - t0)
    times.sort()
    return result, times[len(times) // 2]
