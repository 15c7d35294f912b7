"""User-facing NUTS sampler.

Mirrors the reference's multi-chain ``NUTS`` wrapper
(/root/reference/src/nuts.rs:70-353): construct with a target, initial
positions ``[n_chains, D]`` and a desired average acceptance probability;
``run(n_collect, n_discard)`` adapts the step size during burn-in via dual
averaging and returns ``[n_chains, n_collect, D]`` samples. Collection
follows the reference convention (row 0 is the position at collection start;
``n_collect + n_discard - 1`` steps total, nuts.rs:457-470).

Where the reference Rayon-parallelizes one recursive chain per thread
(nuts.rs:163-170), every chain here advances in lockstep inside one compiled
``lax.scan`` over an iterative masked tree builder (see ``ops/nuts.py``).
"""

from __future__ import annotations

from typing import Optional

import jax

from . import stats as stats_mod
from .models.base import Target
from .ops.nuts import NUTSState, nuts_kernel
from .progress import progress_run
from .runner import make_initial_recording_runner
from .samplers import _fresh_key


class NUTS:
    """No-U-Turn Sampler with dual-averaging step-size adaptation.

    Args:
        target: target distribution (``logp`` and optionally ``grad``).
        initial_positions: ``[n_chains, D]`` starting points.
        target_accept_p: desired average acceptance probability
            (nuts.rs:123-129 takes it as the third constructor argument).
        max_depth: tree-depth cap (the reference recursion is uncapped;
            10 is Stan's default).
        seed: optional base seed.
        metric: optional :class:`~mini_mcmc_tpu.models.Preconditioner` —
            runs NUTS in whitened coordinates ``y = L^-1 x`` (equivalent
            to a ``(L L^T)^-1`` mass matrix; beyond-reference, see
            ``models/precondition.py``). Positions/samples stay in x-space;
            step-size adaptation happens in the whitened space.
    """

    def __init__(
        self,
        target: Target,
        initial_positions,
        target_accept_p: float = 0.8,
        max_depth: int = 10,
        seed: Optional[int] = None,
        warmup_max_depth: Optional[int] = None,
        metric=None,
        transform=None,
    ):
        import jax.numpy as jnp  # noqa: F401 — kept for subclass hooks

        from .samplers import _wrap_sampler_target

        if warmup_max_depth is not None and not (
            1 <= warmup_max_depth <= max_depth
        ):
            raise ValueError(
                f"warmup_max_depth must be in [1, max_depth={max_depth}]; "
                f"got {warmup_max_depth}"
            )
        self.target = target
        self.target_accept_p = target_accept_p
        self.max_depth = max_depth
        self.metric = metric
        self.transform = transform
        self._ctor = dict(
            target_accept_p=target_accept_p, max_depth=max_depth,
            warmup_max_depth=warmup_max_depth, transform=transform,
        )
        kernel_target, self._positions_map, initial_positions = (
            _wrap_sampler_target(target, initial_positions, transform,
                                 metric)
        )
        init_fn, prepare_fn, step_fn = nuts_kernel(
            kernel_target, target_accept_p, max_depth,
            warmup_max_depth=warmup_max_depth,
        )
        # Copy: run() donates state buffers; don't invalidate the caller's
        # (possibly shared) initial-positions array.
        initial_positions = jnp.array(initial_positions, copy=True)
        if initial_positions.ndim != 2:
            raise ValueError(
                "initial_positions must be [n_chains, dim]; got shape "
                f"{initial_positions.shape}"
            )
        self.state: NUTSState = init_fn(initial_positions)
        self._div_before_run = None  # see last_run_divergences
        self._lf_before_run = None  # see last_run_leapfrogs
        self._prepare_fn = jax.jit(prepare_fn, static_argnames=("n_discard",))
        self._step_fn = step_fn
        self._key = _fresh_key(seed)
        runner_kw = dict(tracker_update=stats_mod.tracker_update)
        if self._positions_map is not None:
            # capture the bare map, not self: the lambda is baked into the
            # jitted runner closure (samplers.py does the same)
            pm = self._positions_map
            runner_kw["positions_of"] = lambda s: pm(s.positions)
        self._runner = make_initial_recording_runner(step_fn, **runner_kw)
        # Chunked-progress path uses the simple convention; see run_progress.
        from .runner import make_simple_runner

        self._simple_runner = make_simple_runner(step_fn, **runner_kw)

    def warmed_up(self, n_adapt: int = 300, kind: str = "diag", *,
                  seed=None) -> "NUTS":
        """The full warmup workflow in one call (API-uniform with
        ``HMC.warmed_up``/``MALA.warmed_up``): run ``n_adapt`` adaptation
        steps (NUTS dual-averages its step size in-run, nuts.rs:676-691),
        estimate a metric from the equilibrated cross-chain ensemble, and
        return a whitened continuation. The new sampler re-runs
        ``find_reasonable_epsilon`` + dual averaging in the whitened space
        during its next ``run``'s discard phase, so follow with e.g.
        ``run(n_collect, n_discard=100)``. Advances THIS sampler's chains
        in place for the adaptation leg (the returned sampler continues
        from the equilibrated positions). Without ``seed`` the key chain
        derives from this sampler's stream end-to-end."""
        self.run(0, n_adapt)
        return self.reconditioned(kind, seed=seed)

    def reconditioned(self, kind: str = "diag", *, seed=None) -> "NUTS":
        """New NUTS continuing from the current positions, whitened by a
        metric estimated from the chain ensemble (one cross-chain
        covariance snapshot — the lockstep analog of Stan's warmup
        windows). Run a short adaptation first so the ensemble is in the
        typical set; the new sampler re-runs step-size search in the
        whitened space on its first ``run``. Without ``seed`` the new
        sampler's key derives from this sampler's stream, keeping a fully
        seeded workflow reproducible end-to-end."""
        from .models.precondition import estimate_preconditioner
        from .samplers import _unconstrained_positions

        # estimate from the UNCONSTRAINED ensemble (with a transform set,
        # .positions are natural coordinates but the metric whitens the
        # transform's y-space; identical otherwise)
        pre = estimate_preconditioner(_unconstrained_positions(self), kind)
        new = NUTS(self.target, self.positions, metric=pre, seed=seed,
                   **self._ctor)
        if seed is None:
            new._key = self._next_key()
        return new

    def seed(self, seed: int):
        self._key = jax.random.PRNGKey(seed)
        return self

    set_seed = seed

    def _next_key(self) -> jax.Array:
        self._key, sub = jax.random.split(self._key)
        return sub

    @property
    def positions(self) -> jax.Array:
        if self._positions_map is not None:
            return self._positions_map(self.state.positions)
        return self.state.positions

    @property
    def n_chains(self) -> int:
        return self.state.positions.shape[0]

    @property
    def dim(self) -> int:
        return self.state.positions.shape[1]

    @property
    def step_size(self) -> jax.Array:
        """Per-chain leapfrog step size ``[C]``: the dual-averaging
        ``epsilon`` during adaptation, frozen to ``epsilon_bar`` after
        (nuts.rs:676-691). ``-1.0`` sentinel before the first run
        ("auto": set by ``find_reasonable_epsilon``)."""
        return self.state.epsilon

    @property
    def divergences(self) -> jax.Array:
        """Per-chain count of divergent transitions, cumulative over every
        ``run`` since construction (the reference only uses divergence to
        stop tree growth, nuts.rs:807; exposing the count is the standard
        Stan-style health diagnostic)."""
        return self.state.divergences

    @property
    def last_run_divergences(self) -> jax.Array:
        """Per-chain divergences of the most recent ``run``/``run_progress``
        only. Separates steady-state health from the expected pre-adaptation
        warmup divergences that :attr:`divergences` accumulates — on an easy
        target a converged sampler should show ~0 here while the cumulative
        count carries the first run's adaptation transient."""
        import jax.numpy as jnp

        if self._div_before_run is None:
            return jnp.zeros_like(self.state.divergences)
        return self.state.divergences - self._div_before_run

    @property
    def leapfrogs(self) -> jax.Array:
        """Per-chain count of leapfrog steps EXECUTED (cumulative, like
        :attr:`divergences`) — the lockstep cost including masked-lane
        waste: every chain pays ``2^J - 1`` gradient evals for a J-deep
        doubling loop whether or not its own tree finished earlier
        (ops/nuts.py:21-39). One gradient evaluation per leapfrog (the
        per-step initial gradient and ``find_reasonable_epsilon`` are
        extra). The counter saturates at ~2.0e9 instead of wrapping
        int32 — restart accounting before that for exact per-run deltas.
        ``-1`` only for state restored from a checkpoint that predates the
        counter.
        Divide the per-run delta by the run's steps for grad-evals/draw —
        the number to weigh against ``ChEESHMC``'s fixed
        ``traj_len / (2 * step_size)``."""
        return self.state.leapfrogs

    @property
    def last_run_leapfrogs(self) -> jax.Array:
        """Per-chain executed leapfrogs of the most recent ``run`` only
        (the :attr:`last_run_divergences` convention)."""
        import jax.numpy as jnp

        if bool(jnp.any(self.state.leapfrogs < 0)):
            return jnp.full_like(self.state.leapfrogs, -1)
        if self._lf_before_run is None:
            return jnp.zeros_like(self.state.leapfrogs)
        return self.state.leapfrogs - self._lf_before_run

    def _snapshot_divergences(self):
        import jax.numpy as jnp

        # copy=True: run() donates the state buffers, so a bare reference
        # to the pre-run array would be invalidated by the runner call
        self._div_before_run = jnp.array(self.state.divergences, copy=True)
        self._lf_before_run = jnp.array(self.state.leapfrogs, copy=True)

    def run(self, n_collect: int, n_discard: int = 0, *,
            time_major: bool = False) -> jax.Array:
        """Sample; returns ``[n_chains, n_collect, D]`` — or
        ``[n_collect, n_chains, D]`` with ``time_major=True``, which skips
        the final transpose (halves peak HBM at huge chain counts; pair
        with ``split_rhat_mean_ess(..., time_major=True)``)."""
        self._snapshot_divergences()
        self.state = self._prepare_fn(
            self.state, self._next_key(), n_discard=n_discard
        )
        self.state, sample, _ = self._runner(
            self.state, self._next_key(), n_collect, n_discard,
            time_major=time_major,
        )
        return sample

    def run_progress(self, n_collect: int, n_discard: int = 0, *,
                     stream=None, time_major: bool = False):
        """Sample with live progress bars; returns ``(sample, RunStats)``
        (the analog of nuts.rs:194-338). ``stream`` overrides the output
        stream (default stderr); ``time_major=True`` returns the
        ``[n_collect, C, D]`` layout (same HBM saving as :meth:`run`)."""
        self._snapshot_divergences()
        self.state = self._prepare_fn(
            self.state, self._next_key(), n_discard=n_discard
        )
        # Reduce the initial-recording convention (n_collect + n_discard - 1
        # steps) to the simple chunked driver: with n_discard == 0 the first
        # row is the current position (passed as initial_rows, written
        # straight into the preallocated cube) and n_collect - 1 further
        # steps are recorded; otherwise it equals a simple run with one
        # fewer discard.
        kw = dict(n_chains=self.n_chains, dim=self.dim, stream=stream,
                  time_major=time_major)
        if n_discard == 0:
            kw["initial_rows"] = self.positions[None]  # [1, C, D]
            self.state, sample = progress_run(
                self._simple_runner, self.state, self._next_key(),
                n_collect, 0, **kw,
            )
        else:
            self.state, sample = progress_run(
                self._simple_runner, self.state, self._next_key(),
                n_collect, n_discard - 1, **kw,
            )
        return sample, stats_mod.run_stats(sample, time_major=time_major)
