"""Worker process for the 2-process multihost test (test_parallel.py).

Each process owns ONE virtual CPU device; together they form a 2-device
global chains mesh spanning processes — the analog of a multi-host
accelerator cluster (parallel/multihost.py docstring). Exercises the full
claimed multi-host path: ``multihost.initialize`` (jax.distributed + gloo CPU
collectives), ``global_chain_mesh``, ``host_local_state`` (each process
materializes only its own chain rows), a sharded MH run, and a cross-
process diagnostics reduction.

Usage: ``python multihost_worker.py <process_id> <port> <ckpt_dir>``
"""

import os
import sys

proc_id = int(sys.argv[1])
port = sys.argv[2]
ckpt_dir = sys.argv[3]

# invoked as a script: the repo root (not tests/) must be importable
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mini_mcmc_tpu import stats as stats_mod  # noqa: E402
from mini_mcmc_tpu.models import (  # noqa: E402
    gaussian2d,
    isotropic_gaussian_proposal,
)
from mini_mcmc_tpu.ops.mh import mh_kernel  # noqa: E402
from mini_mcmc_tpu.parallel import multihost  # noqa: E402
from mini_mcmc_tpu.runner import make_simple_runner  # noqa: E402

N_CHAINS, DIM, N_STEPS = 16, 2, 50

multihost.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2,
    process_id=proc_id,
)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 2 and jax.local_device_count() == 1

target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
proposal = isotropic_gaussian_proposal(1.0)
init_fn, step_fn = mh_kernel(target, proposal)
runner = make_simple_runner(step_fn, tracker_update=stats_mod.tracker_update)

mesh = multihost.global_chain_mesh()
key = jax.random.PRNGKey(0)
state = multihost.host_local_state(mesh, init_fn, N_CHAINS, DIM, key)

run_key = jax.random.PRNGKey(1)
tracker = stats_mod.tracker_init(N_CHAINS, DIM)
state, sample, tracker = runner(state, run_key, N_STEPS, 0, tracker=tracker)

# Cross-process diagnostics reduction over the sharded chains axis (the
# only cross-host traffic in the design, multihost.py:6-9).
max_rhat = float(jax.jit(stats_mod.tracker_max_rhat)(tracker))
assert np.isfinite(max_rhat) and max_rhat > 0.0, max_rhat

# The sharded 2-process run must reproduce the single-device run of the
# identical program: rebuild the same initial state locally (fold_in on
# global chain indices — the documented host_local_state contract) and
# replay; compare the locally-owned rows of the final positions.
local_positions = jax.vmap(
    lambda r: jax.random.normal(jax.random.fold_in(key, r), (DIM,),
                                jnp.float32)
)(jnp.arange(N_CHAINS))
ref_state, ref_sample, _ = make_simple_runner(step_fn)(
    init_fn(local_positions), run_key, N_STEPS, 0
)

shard = state.positions.addressable_shards[0]
rows = shard.index[0]
np.testing.assert_allclose(
    np.asarray(shard.data),
    np.asarray(ref_state.positions[rows]),
    rtol=1e-6,
)

# Multi-process checkpoint round-trip: save_checkpoint's allgather AND the
# default orbax backend's save are collectives (global process barriers),
# so EVERY process must reach them — a process-0-only orbax call deadlocks
# (checkpoint.py). Saving the sharded state from both processes and
# restoring must reproduce the gathered global positions bit-exactly.
from mini_mcmc_tpu.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402

ckpt = os.path.join(ckpt_dir, "state")
save_checkpoint(ckpt, state)
from jax.experimental import multihost_utils  # noqa: E402

global_positions = multihost_utils.process_allgather(
    state.positions, tiled=True
)
restored, _ = load_checkpoint(ckpt)
np.testing.assert_array_equal(
    np.asarray(restored.positions), np.asarray(global_positions)
)

print(f"proc {proc_id}: OK max_rhat={max_rhat:.3f}", flush=True)
