"""Multi-chip chain sharding: the pure-data-parallel scaling story.

Chains shard over a 1-D device mesh (``mini_mcmc_tpu.parallel``); the
sampling scan compiles to ZERO cross-device collectives — each chip
advances its chain shard independently, so throughput scales linearly
(pinned by tests/test_parallel.py::test_sampling_scan_compiles_to_zero_
collectives) — while the R-hat/ESS diagnostics reduce across the mesh
transparently. On a multi-GPU host this is the same code (``python
chip_smoke.py --multi`` runs it over four cards); under the test suite it
runs on the 8-virtual-device CPU mesh (tests/conftest.py), the
lockstep analog of the reference's Rayon thread fan-out
(/root/reference/src/core.rs:178-182).
"""

from mini_mcmc_tpu import HMC, init_det, run_stats
from mini_mcmc_tpu.models import rosenbrock_nd
from mini_mcmc_tpu.parallel import chain_mesh, shard_sampler_state


def main():
    mesh = chain_mesh()
    n_devices = mesh.devices.size
    n_chains = 512 * n_devices  # scale the batch with the mesh

    sampler = HMC(rosenbrock_nd(), init_det(n_chains, 3),
                  step_size=0.02, n_leapfrog=16).seed(7)
    sampler.state = shard_sampler_state(mesh, sampler.state)

    sample = sampler.run(256, 64)
    shards = {s.device for s in sample.addressable_shards}
    print(f"{n_chains} chains sharded over {len(shards)} device(s); "
          f"cube {tuple(sample.shape)} stays sharded on the chains axis")
    print(run_stats(sample))  # cross-chain reductions cross the mesh


if __name__ == "__main__":
    main()
