"""Device mesh and chain-sharding helpers.

The reference's only parallelism axes are OS threads over chains (Rayon,
/root/reference/src/core.rs:178-182) — it has no distributed backend at all
(SURVEY.md section 2). The scaling story is pure data parallelism
over the *chains* axis: lay chains out over a 1-D ``jax.sharding.Mesh`` and
let XLA's SPMD partitioner run the identical compiled scan per shard. Chains
never communicate during sampling; only the diagnostics reductions
(between-chain variance for R-hat needs all chain means,
/root/reference/src/stats.rs:155-178) cross chips, and those lower to
``psum``-family collectives over the device interconnect automatically when
computed from sharded arrays.

Model/tensor/pipeline/sequence parallelism are N/A for this workload (no
model layers, no sequence axis — see SURVEY.md section 2); chains are the
single distribution axis, plus optional sharding of very large state
dimensions inside user logp functions.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chains"
DATA_AXIS = "data"
STATE_AXIS = "state"


def chain_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the chains axis.

    Args:
        n_devices: number of devices to use (default: all).
        devices: explicit device list (overrides ``n_devices``).
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (CHAIN_AXIS,))


def data_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over a ``"data"`` axis, for dataset sharding with
    :func:`~mini_mcmc_tpu.data_parallel_grad` (chains stay replicated over
    this axis; the dataset's rows split across it)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (DATA_AXIS,))


def chain_state_mesh(n_chain_shards: int, n_state_shards: int,
                     devices=None) -> Mesh:
    """2-D ``("chains", "state")`` mesh for states too large for one
    chip's HBM: chains split over the first axis, the STATE DIMENSION
    over the second (SURVEY.md section 5's "sharding the state dimension"
    axis for very large d). With ``n_chain_shards=1`` this is pure
    state-dimension sharding.

    Under this mesh, :func:`shard_sampler_state` with
    ``shard_state_dim=True`` lays every ``[C, D]`` leaf out as
    ``P("chains", "state")``; the sampling scan then needs exactly one
    all-reduce-family collective per energy reduction (the logp and
    kinetic-energy sums cross the state axis) and nothing heavier — an
    elementwise-gradient target's leapfrog never communicates. See
    ``tests/test_parallel.py`` for the HLO pin.
    """
    if devices is None:
        devices = jax.devices()
    n = n_chain_shards * n_state_shards
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices for a {n_chain_shards}x{n_state_shards} "
            f"mesh; have {len(devices)}"
        )
    grid = np.array(devices[:n]).reshape(n_chain_shards, n_state_shards)
    return Mesh(grid, (CHAIN_AXIS, STATE_AXIS))


def chain_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Sharding for a ``[chains, ...]`` array: chains split over the mesh,
    trailing axes replicated."""
    spec = P(CHAIN_AXIS, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_chains(mesh: Mesh, array: jax.Array) -> jax.Array:
    """Place a ``[chains, ...]`` array with its leading axis sharded."""
    return jax.device_put(array, chain_sharding(mesh, array.ndim))


def shard_sampler_state(mesh: Mesh, state, *, shard_state_dim: bool = False):
    """Shard every leaf of a sampler state pytree along its chains axis;
    scalar leaves are replicated.

    By default the chains axis is the leading axis of every leaf. A state
    type may override per field with a ``CHAIN_AXIS_INDEX`` class attribute
    mapping field name -> axis index or ``None`` (replicate) — e.g. the
    parallel-tempering state keeps chains on axis 1 behind the temperature
    ladder (``ops/tempering.py``).

    ``shard_state_dim=True`` (requires a mesh with a ``"state"`` axis,
    :func:`chain_state_mesh`) additionally splits the LAST axis of every
    rank >= 2 chain-sharded leaf over that axis — the `[C, D]`
    positions/gradients of states too large for one chip's HBM. Fields a
    state type marks ``None`` in ``CHAIN_AXIS_INDEX`` stay fully
    replicated either way (the marker means replicate-by-design; a
    lookup table's last axis is not the state dimension)."""
    if CHAIN_AXIS not in mesh.axis_names:
        raise ValueError(
            f"shard_sampler_state needs a mesh with a '{CHAIN_AXIS}' "
            f"axis (chain_mesh or chain_state_mesh); got axes "
            f"{mesh.axis_names}"
        )
    if shard_state_dim and STATE_AXIS not in mesh.axis_names:
        raise ValueError(
            f"shard_state_dim=True needs a mesh with a '{STATE_AXIS}' "
            f"axis (see chain_state_mesh); got axes {mesh.axis_names}"
        )

    def spec_for(ndim: int, chain_axis: int) -> P:
        spec = [None] * ndim
        spec[chain_axis] = CHAIN_AXIS
        if (shard_state_dim and ndim >= 2
                and spec[ndim - 1] is None):
            spec[ndim - 1] = STATE_AXIS
        return P(*spec)

    axis_of = getattr(type(state), "CHAIN_AXIS_INDEX", None)
    if axis_of is not None and hasattr(state, "_fields"):
        placed = {}
        for name in state._fields:
            x = getattr(state, name)
            axis = axis_of.get(name, 0)
            if axis is None or getattr(x, "ndim", 0) < 1:
                placed[name] = jax.device_put(x, replicated_sharding(mesh))
            else:
                placed[name] = jax.device_put(
                    x, NamedSharding(mesh, spec_for(x.ndim, axis))
                )
        return type(state)(**placed)

    def place(x):
        ndim = getattr(x, "ndim", 0)
        if ndim >= 1:
            return jax.device_put(x, NamedSharding(mesh, spec_for(ndim, 0)))
        return jax.device_put(x, replicated_sharding(mesh))

    return jax.tree_util.tree_map(place, state)
