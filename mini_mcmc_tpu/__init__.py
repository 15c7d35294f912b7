"""mini-mcmc-tpu: a batched-chain MCMC framework for accelerators.

A from-scratch JAX/XLA rebuild of the capability surface of
``mini-mcmc`` (Rust, reference at /root/reference): Metropolis-Hastings,
Hamiltonian Monte Carlo, the No-U-Turn Sampler and Gibbs sampling over
thousands of lockstep parallel chains — plus beyond-reference
Langevin (``MALA``), ChEES trajectory-length-adapted HMC (``ChEESHMC``),
affine-invariant ensemble (``EnsembleSampler``), coordinate slice
(``SliceSampler``), elliptical slice (``EllipticalSliceSampler``),
replica-exchange (``ParallelTempering``) and minibatch
stochastic-gradient (``SGLD``/pSGLD, ``SGHMC``) samplers
and normalizing-constant estimation (``ais_log_z``, adaptive
``smc_log_z``) — with streaming convergence
diagnostics (acceptance EWMA, live R-hat), Stan-style split R-hat + ESS,
progress reporting, reproducible counter-based PRNG, checkpoint/resume, and
CSV/Arrow/Parquet export of the canonical ``[n_chains, n_collect, dim]``
sample cube.

Design: targets and proposals are pure log-density functions; samplers are
``(init, step)`` kernels over batched ``[n_chains, D]`` state pytrees;
runners are ``lax.scan`` loops compiled once by XLA; chains shard over a
``jax.sharding.Mesh`` axis for multi-device scaling, with diagnostics reduced
by XLA collectives.
"""

from . import io, models, ops, parallel, stats, utils
from .checkpoint import load_checkpoint, save_checkpoint
from .diagnostics import (
    ModernDiagnostics,
    Summary,
    rank_normalized_diagnostics,
    summary,
)
from .nuts import NUTS
from .ops.ais import AISResult, ais_log_z, linear_betas, resample
from .ops.sgmcmc import (
    data_parallel_grad,
    minibatch_grad,
    polynomial_decay,
    target_grad,
)
from .ops.smc import SMCResult, smc_log_z
from .ops.tempering import geometric_betas, tune_betas
from .runner import make_initial_recording_runner, make_simple_runner
from .samplers import (
    HMC,
    MALA,
    SGHMC,
    SGLD,
    ChEESHMC,
    EllipticalSliceSampler,
    EnsembleSampler,
    GibbsSampler,
    MetropolisHastings,
    ParallelTempering,
    SliceSampler,
)
from .stream import StreamResult, stream_run
from .stats import (
    RunStats,
    basic_stats,
    collect_rhat,
    run_stats,
    split_rhat_mean_ess,
)
from .utils.init import chain_keys, init, init_det, init_with_seed

__version__ = "0.1.0"

__all__ = [
    "HMC",
    "MALA",
    "NUTS",
    "ChEESHMC",
    "EllipticalSliceSampler",
    "EnsembleSampler",
    "GibbsSampler",
    "MetropolisHastings",
    "ParallelTempering",
    "SGHMC",
    "SGLD",
    "SliceSampler",
    "AISResult",
    "ais_log_z",
    "linear_betas",
    "resample",
    "SMCResult",
    "smc_log_z",
    "geometric_betas",
    "tune_betas",
    "RunStats",
    "basic_stats",
    "chain_keys",
    "collect_rhat",
    "init",
    "init_det",
    "init_with_seed",
    "io",
    "load_checkpoint",
    "ModernDiagnostics",
    "make_initial_recording_runner",
    "make_simple_runner",
    "data_parallel_grad",
    "minibatch_grad",
    "models",
    "ops",
    "parallel",
    "polynomial_decay",
    "rank_normalized_diagnostics",
    "run_stats",
    "save_checkpoint",
    "split_rhat_mean_ess",
    "stats",
    "StreamResult",
    "stream_run",
    "Summary",
    "summary",
    "target_grad",
    "utils",
]
