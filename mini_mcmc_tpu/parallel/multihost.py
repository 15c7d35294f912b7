"""Multi-host (DCN) scaling helpers.

The reference has no multi-process story at all (SURVEY.md section 2's
parallelism inventory); the path to spanning hosts is
``jax.distributed`` + a global chains mesh. Chains remain pure data
parallelism, so the only cross-host traffic is the diagnostics reductions —
which XLA routes over the intra-host interconnect and the network across
hosts automatically when the mesh spans them.

Usage on each host of a multi-host slice:

    from mini_mcmc_tpu.parallel import multihost
    multihost.initialize()          # jax.distributed.initialize()
    mesh = multihost.global_chain_mesh()
    state = multihost.host_local_state(mesh, init_fn, n_chains, dim, key)
    # ... run as usual; arrays are globally sharded jax.Arrays
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .mesh import chain_mesh, chain_sharding


def initialize(**kwargs) -> None:
    """Initialize the JAX distributed runtime (idempotent convenience
    wrapper around ``jax.distributed.initialize``). Real initialization
    failures (bad coordinator, unreachable hosts) propagate."""
    try:
        if jax.distributed.is_initialized():
            return
    except AttributeError:  # older jax without is_initialized
        pass
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def global_chain_mesh():
    """1-D chains mesh over every device in the job (all hosts)."""
    return chain_mesh()


def host_local_state(mesh, init_fn: Callable, n_chains: int, dim: int,
                     key: jax.Array, dtype=jnp.float32):
    """Build a globally-sharded initial sampler state where each host only
    materializes its own chain shard.

    ``n_chains`` is the *global* chain count; each host draws only the
    rows it owns (via ``fold_in`` on global chain indices, so the result
    is identical to a single-host run with the same key).
    """
    from jax.experimental import multihost_utils  # noqa: F401

    sharding = chain_sharding(mesh, 2)

    def make_global(shape, rows_fn):
        def cb(index):
            start, stop, _ = index[0].indices(shape[0])
            return rows_fn(jnp.arange(start, stop))

        return jax.make_array_from_callback(shape, sharding, cb)

    def rows(indices):
        # one vmapped dispatch per shard (per-row dispatches would cost
        # O(rows) launch latencies)
        return jax.vmap(
            lambda r: jax.random.normal(jax.random.fold_in(key, r), (dim,),
                                        dtype)
        )(indices)

    positions = make_global((n_chains, dim), rows)
    return init_fn(positions)
