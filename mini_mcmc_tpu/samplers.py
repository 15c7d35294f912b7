"""User-facing sampler objects.

Thin stateful wrappers around the pure step kernels in ``ops/``, mirroring
the reference's sampler surface (``MetropolisHastings``
/root/reference/src/metropolis_hastings.rs:87-321, ``HMC``
/root/reference/src/hmc.rs:36-432, ``GibbsSampler``
/root/reference/src/gibbs.rs:34-205): construct with a target and initial
positions, optionally ``seed``, then ``run(n_collect, n_discard)`` returning
the ``[n_chains, n_collect, dim]`` sample cube. The wrapper carries the
sampler state pytree between runs, which makes consecutive runs continue the
chains and makes checkpoint/resume trivial (closing the reference's open TODO
at /root/reference/src/core.rs:134) — see ``mini_mcmc_tpu.checkpoint``.

Seeding: the reference derives per-chain ``SmallRng`` seeds with
algorithm-specific offsets (mh.rs:187-193, gibbs.rs:179-187,
nuts.rs:347-353); here one base key is split per step and folded per chain —
distribution-identical, documented as non-bitwise-compatible.
"""

from __future__ import annotations

import secrets
from typing import Optional

import jax
import jax.numpy as jnp

from . import stats as stats_mod
from .models.base import Conditional, Proposal, Target
from .ops.elliptical import elliptical_kernel
from .ops.ensemble import ensemble_kernel
from .ops.gibbs import gibbs_kernel
from .ops.hmc import hmc_kernel
from .ops.mh import mh_kernel
from .ops.slice import slice_kernel
from .ops.tempering import geometric_betas, tempering_kernel
from .progress import progress_run
from .runner import _default_positions_of, make_simple_runner


def _fresh_key(seed: Optional[int]) -> jax.Array:
    if seed is None:
        seed = secrets.randbits(63)
    return jax.random.PRNGKey(seed)


def _check_transformed_inits(transform, y):
    """Eagerly reject initial positions outside the transform's range.

    ``to_y`` maps natural -> unconstrained via each bijector's inverse,
    which is only defined on the bijector's range: a natural user mistake
    (a negative init for a ``positive()`` coordinate, a probability above
    1 for ``interval``) produces ``log`` of a negative number — NaN — and
    the kernel would then cache NaN logp/grad and freeze that chain
    silently. One eager host check at construction turns that into a
    named error. (Values exactly ON a boundary don't reach here: the
    built-in saturating inverses snap them just inside the range.)"""
    import numpy as np

    arr = np.asarray(y)
    bad = ~np.isfinite(arr)
    if not bad.any():
        return
    chains, dims = np.nonzero(bad.reshape(arr.shape[0], -1))
    shown = ", ".join(
        f"(chain {c}, coordinate {d}: {transform._table[d].name})"
        for c, d in list(zip(chains, dims))[:5]
    )
    raise ValueError(
        f"initial positions map to non-finite unconstrained values at "
        f"{int(bad.sum())} entries — they lie outside the transform's "
        f"range (e.g. a negative value for a positive() coordinate, or a "
        f"value above `high` for interval()). First offenders: {shown}. "
        "Initial positions are given in NATURAL coordinates and must lie "
        "inside every constrained coordinate's range."
    )


def _wrap_sampler_target(target, initial_positions, transform, metric):
    """Compose the gradient samplers' coordinate wrappers.

    ``transform`` (natural -> unconstrained, ``models/transforms.py``)
    applies first, then ``metric`` whitening (``models/precondition.py``)
    on the UNCONSTRAINED coordinates. Returns ``(kernel_target,
    positions_map, kernel_initial_positions)`` where ``positions_map``
    takes kernel coordinates back to the user's (natural) coordinates —
    applied inside the collection scan and to ``.positions``.
    """
    kernel_target, positions_map = target, None
    if transform is not None and not transform.is_identity:
        kernel_target = transform.wrap(target)
        positions_map = transform.to_x
        initial_positions = transform.to_y(jnp.asarray(initial_positions))
        _check_transformed_inits(transform, initial_positions)
    if metric is not None:
        from .models.precondition import precondition_target

        inner_map = positions_map
        kernel_target = precondition_target(kernel_target, metric)
        if inner_map is None:
            positions_map = metric.to_x
        else:
            def positions_map(p, _m=metric.to_x, _t=inner_map):
                return _t(_m(p))
        initial_positions = metric.to_y(jnp.asarray(initial_positions))
    return kernel_target, positions_map, initial_positions


def _unconstrained_positions(sampler):
    """The chain ensemble in UNCONSTRAINED (but unwhitened) coordinates —
    what ``estimate_preconditioner`` must see: the kernel runs (and any
    metric whitens) in the transform's y-space, so estimating from the
    natural-coordinates ``.positions`` would whiten the wrong space."""
    pos = sampler.state.positions
    if sampler.metric is not None:
        pos = sampler.metric.to_x(pos)
    return pos


class _KernelSampler:
    """Shared run/run_progress plumbing for kernel-based samplers."""

    #: collection convention; NUTS overrides (see ops/nuts.py)
    _record_initial = False

    def __init__(self, init_fn, step_fn, initial_positions, seed=None,
                 positions_map=None):
        # Copy: run() donates the state buffers to XLA; the caller's array
        # must not be invalidated (and may be shared across samplers).
        initial_positions = jnp.array(initial_positions, copy=True)
        if initial_positions.ndim != 2:
            raise ValueError(
                "initial_positions must be [n_chains, dim]; got shape "
                f"{initial_positions.shape}"
            )
        self.state = init_fn(initial_positions)
        self._step_fn = step_fn
        self._key = _fresh_key(seed)
        # positions_map: optional [..., D] -> [..., D] map from the state's
        # internal coordinates to user coordinates (metric whitening,
        # models/precondition.py). Applied inside the collection scan (one
        # fused op per recorded row) and to the `positions` property.
        self._positions_map = positions_map
        positions_of = (
            (lambda s: positions_map(s.positions))
            if positions_map is not None else _default_positions_of
        )
        block_fn = getattr(step_fn, "block_fn", None)
        if block_fn is not None:
            # K sampler steps per block call (ops/hmc.py steps_per_call);
            # run() lengths must be multiples of K.
            from .runner import make_block_runner

            # Block kernels may emit rows already in user [K, C, D]
            # coordinates (block_fn.rows_mapped, e.g. the tempering cold-rung
            # block) — only wrap the ones that return raw internal state
            # rows.
            if (positions_map is not None
                    and not getattr(block_fn, "rows_mapped", False)):
                raw_block = block_fn

                def block_fn(state, key):
                    state, rows = raw_block(state, key)
                    return state, positions_map(rows)

            self._runner = make_block_runner(
                block_fn, step_fn.block_size,
                tracker_update=stats_mod.tracker_update,
            )
            # run_progress drives the block runner for the K-aligned bulk
            # of each chunk (same throughput/memory envelope as headless
            # runs); the per-step runner covers sub-K tails only.
            self._progress_runner = self._runner
            self._progress_block_size = step_fn.block_size
            self._progress_tail_runner = make_simple_runner(
                step_fn, positions_of=positions_of,
                tracker_update=stats_mod.tracker_update,
            )
        else:
            self._runner = make_simple_runner(
                step_fn, positions_of=positions_of,
                tracker_update=stats_mod.tracker_update,
            )
            self._progress_runner = self._runner
            self._progress_block_size = 1
            self._progress_tail_runner = self._runner

    # -- seeding -----------------------------------------------------------
    def seed(self, seed: int):
        """Reseed the sampler (chainable, like the reference's
        ``seed``/``set_seed`` builders)."""
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

    # -- running -----------------------------------------------------------
    def run(self, n_collect: int, n_discard: int = 0, *,
            time_major: bool = False) -> jax.Array:
        """Advance ``n_collect + n_discard`` steps; return the last
        ``n_collect`` states as ``[n_chains, n_collect, dim]`` — or
        ``[n_collect, n_chains, dim]`` with ``time_major=True``, which
        skips the final transpose (halves peak HBM at huge chain counts;
        pair with ``split_rhat_mean_ess(..., time_major=True)``)."""
        self.state, sample, _ = self._runner(
            self.state, self._next_key(), n_collect, n_discard,
            time_major=time_major,
        )
        return sample

    def run_progress(self, n_collect: int, n_discard: int = 0, *,
                     stream=None, time_major: bool = False):
        """Like :meth:`run`, with live progress (a global bar plus rotating
        per-chain ``p(accept)`` bars, the lockstep analog of
        /root/reference/src/core.rs:208-360) and final
        :class:`~mini_mcmc_tpu.stats.RunStats`. ``stream`` overrides the
        output stream (default stderr); ``time_major=True`` returns the
        ``[n_collect, C, D]`` layout (same HBM saving as :meth:`run`)."""
        self.state, sample = progress_run(
            self._progress_runner,
            self.state,
            self._next_key(),
            n_collect,
            n_discard,
            n_chains=self.n_chains,
            dim=self.dim,
            stream=stream,
            time_major=time_major,
            block_size=self._progress_block_size,
            tail_runner=self._progress_tail_runner,
        )
        return sample, stats_mod.run_stats(sample, time_major=time_major)


class MetropolisHastings(_KernelSampler):
    """Batched Metropolis-Hastings over parallel chains.

    Example:
        >>> from mini_mcmc_tpu import MetropolisHastings, init_det
        >>> from mini_mcmc_tpu.models import gaussian2d, isotropic_gaussian_proposal
        >>> target = gaussian2d([0., 0.], [[1., 0.], [0., 1.]])
        >>> mh = MetropolisHastings(target, isotropic_gaussian_proposal(1.0),
        ...                         init_det(4, 2)).seed(42)
        >>> sample = mh.run(1000, 100)
        >>> sample.shape
        (4, 1000, 2)
    """

    def __init__(self, target: Target, proposal: Proposal, initial_positions,
                 seed: Optional[int] = None, steps_per_call: int = 1,
                 transform=None):
        self.target = target
        self.proposal = proposal
        self.transform = transform
        #: proposal scale factor vs. the originally constructed proposal
        #: (1.0 unless this sampler came from :meth:`tuned`)
        self.scale_factor = 1.0
        self._ctor = dict(steps_per_call=steps_per_call, transform=transform)
        # transform: the target is a natural-coordinates density and the
        # PROPOSAL walks the unconstrained space (models/transforms.py);
        # initial positions / samples / .positions stay natural.
        kernel_target, positions_map, initial_positions = (
            _wrap_sampler_target(target, initial_positions, transform, None)
        )
        init_fn, step_fn = mh_kernel(kernel_target, proposal,
                                     steps_per_call=steps_per_call)
        super().__init__(init_fn, step_fn, initial_positions, seed,
                         positions_map=positions_map)

    #: random-walk optimal acceptance rate (Roberts, Gelman & Gilks 1997)
    _default_target_accept = 0.234

    def tuned(self, n_adapt: int = 500, *, target_accept=None,
              seed=None) -> "MetropolisHastings":
        """New sampler continuing from the warmed-up positions with the
        proposal scale adapted by dual averaging (beyond-reference — the
        reference's proposal scale is fixed forever; this reuses
        ``ops/adapt.py``, the same Hoffman & Gelman Alg. 6 machinery that
        tunes the HMC/MALA step size). Runs ``n_adapt`` adaptation steps
        from the current state driving the cross-chain mean acceptance
        toward ``target_accept`` (default 0.234, the random-walk optimum),
        then freezes the averaged scale factor.

        Requires a proposal built with a ``scaled`` family
        (``isotropic_gaussian_proposal`` and
        ``gaussian_random_walk_proposal`` provide one). The adapted factor
        is exposed as ``scale_factor`` on the returned sampler. Without
        ``seed`` the new sampler's key derives from this sampler's stream,
        so a fully seeded workflow stays reproducible end-to-end."""
        if self.proposal.scaled is None:
            raise ValueError(
                "tuned() needs a proposal with a `scaled` family "
                "(Proposal.scaled); the built-in Gaussian random-walk "
                "proposals provide one"
            )
        from .ops.adapt import dual_average_step_size
        from .ops.mh import mh_step_alpha

        if target_accept is None:
            target_accept = self._default_target_accept
        step_eps = mh_step_alpha(self.target, self.proposal.scaled)
        state, factor, _ = dual_average_step_size(
            step_eps, self.state, self._next_key(), n_adapt,
            1.0, target_accept,
        )
        # float(): the factor enters the new proposal's closures as a
        # Python scalar (a compile-time constant), not a captured device
        # array.
        factor = float(factor)
        positions = state.positions  # kernel (unconstrained) coordinates
        if self.transform is not None and not self.transform.is_identity:
            positions = self.transform.to_x(positions)
        new = MetropolisHastings(
            self.target, self.proposal.scaled(factor),
            positions, seed=seed, **self._ctor,
        )
        # cumulative vs. the ORIGINAL proposal: self.proposal is already
        # scaled by self.scale_factor when self came from tuned()
        new.scale_factor = self.scale_factor * factor
        if seed is None:
            new._key = self._next_key()
        return new


class HMC(_KernelSampler):
    """Batched Hamiltonian Monte Carlo (data-parallel leapfrog).

    Mirrors ``HMC::new(target, initial_positions, step_size, n_leapfrog)``
    (/root/reference/src/hmc.rs:87-109).

    ``metric``: optional :class:`~mini_mcmc_tpu.models.Preconditioner` —
    runs the sampler in whitened coordinates ``y = L^-1 x`` (equivalent to
    HMC with mass matrix ``(L L^T)^-1``; the reference has no metric).
    ``initial_positions``, recorded samples, and ``.positions`` all stay in
    x-space; the whitening is internal. See ``models/precondition.py``.

    ``transform``: optional
    :class:`~mini_mcmc_tpu.models.CoordinateTransform` — ``target`` is
    then a NATURAL-coordinates density (e.g. ``tau > 0`` with no Jacobian
    terms) and the sampler runs on the unconstrained wrap internally
    (``models/transforms.py``); ``initial_positions``, recorded samples,
    and ``.positions`` all stay in natural coordinates. Composes with
    ``metric`` (the whitening applies to the unconstrained coordinates).
    """

    def __init__(self, target: Target, initial_positions, step_size: float,
                 n_leapfrog: int, seed: Optional[int] = None,
                 unroll: int = 8, jitter: float = 0.0,
                 steps_per_call: int = 1, metric=None, transform=None):
        self.target = target
        self.step_size = step_size
        self.n_leapfrog = n_leapfrog
        self.metric = metric
        self.transform = transform
        self._ctor = dict(step_size=step_size, n_leapfrog=n_leapfrog,
                          unroll=unroll, jitter=jitter,
                          steps_per_call=steps_per_call, transform=transform)
        kernel_target, positions_map, initial_positions = _wrap_sampler_target(
            target, initial_positions, transform, metric,
        )
        init_fn, step_fn = hmc_kernel(kernel_target, step_size, n_leapfrog,
                                      unroll=unroll, jitter=jitter,
                                      steps_per_call=steps_per_call)
        super().__init__(init_fn, step_fn, initial_positions, seed,
                         positions_map=positions_map)

    #: dual-averaging default: the optimal acceptance rate for fixed-L HMC
    #: (Beskos et al. 2013); MALA overrides with its 0.574 optimum.
    _default_target_accept = 0.651

    @classmethod
    def _construct(cls, target, positions, metric, seed, ctor):
        """Rebuild hook for :meth:`tuned`/:meth:`reconditioned` — subclasses
        with narrower signatures (MALA) filter ``ctor`` here."""
        return cls(target, positions, metric=metric, seed=seed, **ctor)

    def tuned(self, n_adapt: int = 500, *, target_accept=None,
              seed=None) -> "HMC":
        """New sampler continuing from the warmed-up positions at a step
        size adapted by dual averaging (``ops/adapt.py`` — Hoffman &
        Gelman Alg. 6 with the reference's NUTS constants, here applied to
        the fixed-trajectory kernels the reference never adapts). Runs
        ``n_adapt`` adaptation steps from the current state, then freezes
        ``exp(log_eps_bar)``. ``target_accept`` defaults to the
        algorithm's optimum (0.651 for HMC, 0.574 for MALA). Without
        ``seed`` the new sampler's key derives from this sampler's stream,
        so a fully seeded workflow stays reproducible end-to-end."""
        from .ops.adapt import dual_average_step_size

        if target_accept is None:
            target_accept = self._default_target_accept
        state, eps, _ = dual_average_step_size(
            self._step_fn.step_eps, self.state, self._next_key(), n_adapt,
            self._ctor["step_size"], target_accept,
        )
        # state.positions are in KERNEL coordinates (whitened when a
        # metric is set, unconstrained when a transform is set); the
        # constructor expects the user's natural coordinates and re-wraps.
        positions = (
            state.positions if self.metric is None
            else self.metric.to_x(state.positions)
        )
        if self.transform is not None and not self.transform.is_identity:
            positions = self.transform.to_x(positions)
        ctor = dict(self._ctor)
        ctor["step_size"] = eps
        new = type(self)._construct(self.target, positions, self.metric,
                                    seed, ctor)
        if seed is None:
            new._key = self._next_key()
        return new

    def warmed_up(self, n_adapt: int = 300, kind: str = "diag", *,
                  target_accept=None, seed=None) -> "HMC":
        """The full warmup workflow in one call — the lockstep analog of
        Stan's windowed adaptation, composed from the two primitives:

        1. :meth:`tuned` (``n_adapt`` steps): dual-average the step size at
           the CURRENT metric, which also equilibrates the ensemble;
        2. :meth:`reconditioned` (``kind``): estimate a metric from the
           equilibrated cross-chain ensemble and whiten;
        3. :meth:`tuned` again (``n_adapt`` steps): re-tune the step size
           in the whitened coordinates, where the optimum is different.

        Returns a new sampler (same class) ready for production ``run()``
        calls. Total adaptation cost: ``2 * n_adapt`` sampler steps plus
        one covariance snapshot. ``target_accept`` applies to BOTH tuning
        legs. Without ``seed`` the key chain derives from this sampler's
        stream end-to-end."""
        rough = self.tuned(n_adapt, target_accept=target_accept)
        pre = rough.reconditioned(kind)
        return pre.tuned(n_adapt, target_accept=target_accept, seed=seed)

    def reconditioned(self, kind: str = "diag", *, seed=None,
                      step_size=None, n_leapfrog=None) -> "HMC":
        """New HMC continuing from the current positions, whitened by a
        metric estimated from the chain ensemble (one cross-chain
        covariance snapshot — the lockstep analog of Stan's warmup
        windows). Run a short warmup first so the ensemble is in the
        typical set. ``kind``: ``"diag"`` or ``"dense"``.

        The step size moves to whitened units: by default
        ``eps_y = eps_x / sigma_min(metric)``, which keeps the stiffest
        dimension's stability margin (an x-space-tuned eps carried over
        unchanged would blow up leapfrog energy once the scales are far
        from 1); pass ``step_size``/``n_leapfrog`` to override. Without
        ``seed`` the new sampler's key derives from this sampler's stream,
        so a fully seeded workflow stays reproducible end-to-end."""
        from .models.precondition import estimate_preconditioner

        # estimate from the UNCONSTRAINED ensemble: with a transform set,
        # .positions are natural coordinates but the metric whitens the
        # transform's y-space (identical to .positions otherwise)
        pre = estimate_preconditioner(_unconstrained_positions(self), kind)
        ctor = dict(self._ctor)
        # The carried step size is in this sampler's KERNEL coordinates:
        # x-space for a plain HMC, whitened y-space when self.metric is
        # set. Re-whitening with the new metric must start from an x-space
        # eps, so undo the old whitening first (eps_x = eps_y * sigma_min).
        eps_x = ctor["step_size"] * (
            self.metric.sigma_min() if self.metric is not None else 1.0
        )
        ctor["step_size"] = (
            step_size if step_size is not None else eps_x / pre.sigma_min()
        )
        if n_leapfrog is not None:
            ctor["n_leapfrog"] = n_leapfrog
        new = type(self)._construct(self.target, self.positions, pre, seed,
                                    ctor)
        if seed is None:
            new._key = self._next_key()
        return new


class MALA(HMC):
    """Metropolis-adjusted Langevin algorithm — beyond-reference, the
    one-gradient-per-step member of the gradient family.

    Proposal ``x' = x + (eps^2 / 2) * grad_logp(x) + eps * xi`` with
    ``xi ~ N(0, I)``, accepted with the exact asymmetric-proposal
    Metropolis correction. Implemented as single-leapfrog HMC, which is
    ALGEBRAICALLY IDENTICAL (substituting one leapfrog step into the
    Hamiltonian accept ratio reproduces the MALA ratio term for term, with
    the momentum Gaussian supplying the forward/reverse q densities), so
    the cached-gradient state, ``metric=`` whitening, and checkpointing all
    carry over from ``ops/hmc.py`` unchanged. ``step_size`` IS the proposal
    std ``eps`` (i.e. the classic MALA time step ``tau = eps^2 / 2``).

    Use :meth:`tuned` to dual-average the step size toward the MALA
    optimum acceptance 0.574 (Roberts & Rosenthal 1998); prefer plain
    :class:`HMC` when the target is smooth enough for long trajectories
    (MALA trades trajectory length for per-step cost — it wins when
    gradients are expensive or the chain count, not the step count, is
    the scaling axis).

    Example:
        >>> from mini_mcmc_tpu import MALA, init_det
        >>> from mini_mcmc_tpu.models import gaussian2d
        >>> target = gaussian2d([0., 0.], [[1., 0.], [0., 1.]])
        >>> mala = MALA(target, init_det(4, 2), step_size=1.0).seed(42)
        >>> mala.run(1000, 100).shape
        (4, 1000, 2)
    """

    _default_target_accept = 0.574

    def __init__(self, target: Target, initial_positions, step_size: float,
                 seed: Optional[int] = None, steps_per_call: int = 1,
                 metric=None, transform=None):
        super().__init__(target, initial_positions, step_size,
                         n_leapfrog=1, seed=seed, unroll=1,
                         steps_per_call=steps_per_call, metric=metric,
                         transform=transform)

    @classmethod
    def _construct(cls, target, positions, metric, seed, ctor):
        ctor = {k: v for k, v in ctor.items()
                if k not in ("n_leapfrog", "unroll", "jitter")}
        return cls(target, positions, metric=metric, seed=seed, **ctor)

    def reconditioned(self, kind: str = "diag", *, seed=None,
                      step_size=None, n_leapfrog=None) -> "MALA":
        if n_leapfrog is not None:
            raise ValueError(
                "MALA has no trajectory length to override "
                "(n_leapfrog is fixed at 1); use HMC for longer "
                "trajectories"
            )
        return super().reconditioned(kind, seed=seed, step_size=step_size)


class ChEESHMC(_KernelSampler):
    """Jittered-trajectory HMC with ChEES trajectory-length adaptation
    (Hoffman, Radul & Sountsov 2021) — beyond-reference, the lockstep
    alternative to NUTS built for exactly this framework's regime.

    Where NUTS adapts the trajectory per chain with dynamic trees (paying
    for masked lanes and tree bookkeeping in lockstep), ChEES keeps every chain
    on ONE shared jittered trajectory and adapts its LENGTH from a
    cross-chain criterion — more chains make the adaptation better, and
    after warmup the kernel is plain fixed-cost HMC with zero cross-chain
    communication (``ops/chees.py``).

    Workflow: construct with a rough ``step_size`` (the trajectory length
    defaults to one leapfrog), call :meth:`warmed_up` to jointly adapt the
    step size (dual averaging toward ``target_accept=0.651``) and the
    trajectory length (Adam ascent on the ChEES criterion), then ``run()``.

    ``metric``: optional :class:`~mini_mcmc_tpu.models.Preconditioner`,
    the same whitening contract as :class:`HMC`.

    Example:
        >>> from mini_mcmc_tpu import ChEESHMC, init_det
        >>> from mini_mcmc_tpu.models import gaussian2d
        >>> target = gaussian2d([0., 0.], [[1., 0.], [0., 1.]])
        >>> ch = ChEESHMC(target, init_det(64, 2), step_size=0.5, seed=42)
        >>> ch = ch.warmed_up(200)
        >>> ch.run(500, 100).shape
        (64, 500, 2)
    """

    _default_target_accept = 0.651

    def __init__(self, target: Target, initial_positions, step_size: float,
                 traj_len: Optional[float] = None,
                 max_leapfrog: int = 1024, seed: Optional[int] = None,
                 metric=None, transform=None):
        from .ops.chees import chees_hmc_kernel

        self.target = target
        self.step_size = step_size
        #: total integration time T; each step integrates for u*T with
        #: u ~ U(0,1), i.e. mean trajectory T / (2 * step_size) leapfrogs.
        self.traj_len = float(traj_len) if traj_len is not None else step_size
        self.max_leapfrog = max_leapfrog
        self.metric = metric
        self.transform = transform
        kernel_target, positions_map, initial_positions = (
            _wrap_sampler_target(target, initial_positions, transform,
                                 metric)
        )
        self._kernel_target = kernel_target
        init_fn, step_fn = chees_hmc_kernel(
            kernel_target, step_size, self.traj_len, max_leapfrog,
        )
        super().__init__(init_fn, step_fn, initial_positions, seed,
                         positions_map=positions_map)

    def warmed_up(self, n_adapt: int = 500, *, target_accept=None,
                  adam_lr: float = 0.025, seed=None) -> "ChEESHMC":
        """New sampler continuing from the adapted positions with jointly
        tuned ``step_size`` and ``traj_len`` (``ops/chees.py
        chees_adapt``: one scan of ``n_adapt`` jittered steps — Halton
        trajectory jitter, dual-averaged step size, Adam on the ChEES
        criterion). The adaptation trace is exposed on the returned
        sampler as ``warmup_trace`` (``alpha``/``traj_len``/``eps`` per
        step). Without ``seed`` the new sampler's key derives from this
        sampler's stream, so a fully seeded workflow stays reproducible
        end-to-end."""
        from .ops.chees import chees_adapt

        if target_accept is None:
            target_accept = self._default_target_accept
        state, eps, traj_len, trace = chees_adapt(
            self._kernel_target, self.state, self._next_key(), n_adapt,
            self.step_size, self.traj_len, target_accept=target_accept,
            adam_lr=adam_lr, max_leapfrog=self.max_leapfrog,
        )
        # float(): the adapted values enter the new kernel's closures as
        # compile-time constants, not captured device arrays (the
        # MetropolisHastings.tuned convention)
        eps, traj_len = float(eps), float(traj_len)
        positions = (
            state.positions if self.metric is None
            else self.metric.to_x(state.positions)
        )
        if self.transform is not None and not self.transform.is_identity:
            positions = self.transform.to_x(positions)
        new = ChEESHMC(self.target, positions, eps, traj_len,
                       max_leapfrog=self.max_leapfrog, seed=seed,
                       metric=self.metric, transform=self.transform)
        new.warmup_trace = trace
        if seed is None:
            new._key = self._next_key()
        return new

    def reconditioned(self, kind: str = "diag", *, seed=None,
                      step_size=None, traj_len=None) -> "ChEESHMC":
        """New ChEESHMC continuing from the current positions, whitened by
        an ensemble-estimated metric (the :meth:`HMC.reconditioned`
        contract). Both the step size and the trajectory length move to
        whitened units via ``sigma_min`` (undoing any previous metric
        first); pass ``step_size``/``traj_len`` to override. A follow-up
        :meth:`warmed_up` re-tunes both in the new coordinates."""
        from .models.precondition import estimate_preconditioner

        pre = estimate_preconditioner(_unconstrained_positions(self), kind)
        old_scale = (
            self.metric.sigma_min() if self.metric is not None else 1.0
        )
        eps_x = self.step_size * old_scale
        t_x = self.traj_len * old_scale
        new = ChEESHMC(
            self.target, self.positions,
            step_size if step_size is not None else eps_x / pre.sigma_min(),
            traj_len if traj_len is not None else t_x / pre.sigma_min(),
            max_leapfrog=self.max_leapfrog, seed=seed, metric=pre,
            transform=self.transform,
        )
        if seed is None:
            new._key = self._next_key()
        return new


class EnsembleSampler(_KernelSampler):
    """Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch
    move, the ``emcee`` algorithm) — beyond-reference, gradient-free.

    ``initial_positions [C, D]`` holds ``C / walkers_per_ensemble``
    independent ensembles advancing in one lockstep batch
    (``ops/ensemble.py``); by default all ``C`` chains form ONE ensemble.
    Use >= 2*D walkers per ensemble; spread the initial walker cloud (the
    move interpolates through pairs, so a degenerate cloud collapses).
    One ``run`` row per full sweep (both halves updated).

    Example:
        >>> from mini_mcmc_tpu import EnsembleSampler, init_det
        >>> from mini_mcmc_tpu.models import gaussian2d
        >>> target = gaussian2d([0., 0.], [[1., 0.], [0., 1.]])
        >>> es = EnsembleSampler(target, init_det(32, 2)).seed(42)
        >>> es.run(1000, 100).shape
        (32, 1000, 2)
    """

    def __init__(self, target: Target, initial_positions,
                 walkers_per_ensemble: Optional[int] = None, a: float = 2.0,
                 seed: Optional[int] = None, steps_per_call: int = 1,
                 transform=None):
        self.target = target
        self.a = a
        self.transform = transform
        # transform: the stretch move interpolates pairs in the
        # UNCONSTRAINED space (affine invariance holds there); samples
        # and .positions stay natural
        kernel_target, positions_map, initial_positions = (
            _wrap_sampler_target(target, initial_positions, transform, None)
        )
        n_chains = jnp.shape(jnp.asarray(initial_positions))[0]
        if walkers_per_ensemble is None:
            walkers_per_ensemble = n_chains
        self.walkers_per_ensemble = walkers_per_ensemble
        init_fn, step_fn = ensemble_kernel(
            kernel_target, walkers_per_ensemble=walkers_per_ensemble, a=a,
            steps_per_call=steps_per_call,
        )
        super().__init__(init_fn, step_fn, initial_positions, seed,
                         positions_map=positions_map)


class ParallelTempering(_KernelSampler):
    """Replica-exchange random-walk Metropolis (beyond-reference).

    ``C`` logical chains, each with ``len(betas)`` replicas against the
    tempered densities ``beta * logp``; all ``T * C`` replicas advance in
    one lockstep batch and neighboring temperatures exchange states with
    the Metropolis swap rule each step (``ops/tempering.py``). The sample
    cube contains only the cold (beta = 1) replicas —
    ``[n_chains, n_collect, dim]`` like every other sampler; hot replicas
    are internal (checkpointed) state. This is the tool for multimodal
    targets where single-temperature MH mixes between modes at an
    exponentially small rate.

    ``betas``: the ladder, defaults to ``geometric_betas(8)``;
    ``proposal_std``: cold-chain random-walk scale (scalar or ``[D]``),
    hotter replicas scale it by ``1/sqrt(beta)``; ``n_inner``:
    within-temperature sweeps per swap sweep. ``swap_acceptance`` exposes
    the streaming per-pair EWMA (tune the ladder toward ~20-40%).
    """

    def __init__(self, target: Target, initial_positions,
                 betas: Optional[tuple] = None, proposal_std=1.0,
                 n_inner: int = 1, seed: Optional[int] = None,
                 steps_per_call: int = 1, transform=None):
        self.target = target
        self.transform = transform
        if betas is None:
            betas = geometric_betas(8)
        self.betas = tuple(float(b) for b in betas)
        self._ctor = dict(proposal_std=proposal_std, n_inner=n_inner,
                          steps_per_call=steps_per_call, transform=transform)
        # transform: replicas walk the unconstrained space (the tempered
        # densities are beta * wrapped logp); the cold cube stays natural
        kernel_target, tf_map, initial_positions = _wrap_sampler_target(
            target, initial_positions, transform, None,
        )
        n_cold = jnp.shape(jnp.asarray(initial_positions))[0]
        self._n_cold = int(n_cold)
        init_fn, step_fn = tempering_kernel(
            kernel_target, self.betas, proposal_std=proposal_std,
            n_inner=n_inner, steps_per_call=steps_per_call,
        )

        # positions_map extracts the cold ladder rung (rung 0) from the
        # [..., T, D, C] chains-on-lanes replica batch and restores the
        # [C, D] user layout — the ellipsis covers the block runner's
        # [K, T, D, C] row stacks as well as the bare state — then maps
        # back to natural coordinates when a transform is set.
        def positions_map(p, _tf=tf_map):
            cold = jnp.swapaxes(p[..., 0, :, :], -1, -2)
            return cold if _tf is None else _tf(cold)

        super().__init__(
            init_fn, step_fn, initial_positions, seed,
            positions_map=positions_map,
        )

    @property
    def n_chains(self) -> int:
        return self._n_cold

    @property
    def dim(self) -> int:
        return self.state.positions.shape[1]

    @property
    def n_replicas(self) -> int:
        t, _, c = self.state.positions.shape
        return t * c

    @property
    def swap_acceptance(self) -> jax.Array:
        """``[T-1]`` streaming EWMA of neighbor swap acceptance (mean over
        chains; the per-chain ``[T-1, C]`` surface is
        ``state.swap_accept``)."""
        return jnp.mean(self.state.swap_accept, axis=1)

    def retuned(self, n_temps: Optional[int] = None, *,
                seed=None) -> "ParallelTempering":
        """New sampler continuing from the current cold positions on a
        ladder re-spaced by :func:`~mini_mcmc_tpu.tune_betas` (equal
        increments of the communication barrier measured by this run's
        swap-acceptance EWMA) — the tempering analog of
        :meth:`HMC.reconditioned`. Run a short leg first so the EWMA has
        converged. Hot replicas restart from the cold state (they
        re-equilibrate within a few sweeps). Without ``seed`` the new
        sampler's key derives from this sampler's stream, so a fully
        seeded workflow stays reproducible end-to-end."""
        from .ops.tempering import tune_betas

        tuned = tune_betas(self.betas, self.swap_acceptance,
                           n_temps=n_temps)
        new = ParallelTempering(self.target, self.positions, betas=tuned,
                                seed=seed, **self._ctor)
        if seed is None:
            new._key = self._next_key()
        return new


class EllipticalSliceSampler(_KernelSampler):
    """Elliptical slice sampling (Murray, Adams & MacKay 2010) —
    beyond-reference, the tuning-free sampler for Gaussian-prior models.

    Samples ``p(x) ∝ N(x; prior_mean, Sigma) * L(x)``: pass the
    LIKELIHOOD ``L`` as ``loglik`` (a :class:`~mini_mcmc_tpu.models.base.
    Target`; only ``logp`` is used) and the prior via ``prior_mean`` +
    ``prior_scale`` (scalar std, ``[D]`` stds, or a ``[D, D]``
    lower-Cholesky of the covariance). The prior is handled EXACTLY by
    the ellipse construction — do not fold it into ``loglik``. No step
    size, no bracket width, no acceptance target: every update accepts
    within a few geometric bracket shrinks (``ops/elliptical.py``).

    This is the workhorse for latent Gaussian models (GP regression/
    classification with non-Gaussian likelihoods), where ``D`` is the
    number of latent function values and the prior Cholesky draw is one
    batched matmul.

    Example:
        >>> import jax.numpy as jnp
        >>> from mini_mcmc_tpu import EllipticalSliceSampler, init_det
        >>> from mini_mcmc_tpu.models.base import Target
        >>> lik = Target(logp=lambda x: -0.5 * jnp.sum((x - 1.0) ** 2))
        >>> es = EllipticalSliceSampler(lik, init_det(4, 2)).seed(42)
        >>> es.run(1000, 100).shape
        (4, 1000, 2)
    """

    def __init__(self, loglik: Target, initial_positions, prior_mean=0.0,
                 prior_scale=1.0, max_shrink: int = 32,
                 seed: Optional[int] = None, steps_per_call: int = 1):
        self.loglik = loglik
        self.prior_mean = prior_mean
        self.prior_scale = prior_scale
        init_fn, step_fn = elliptical_kernel(
            loglik, prior_mean=prior_mean, prior_scale=prior_scale,
            max_shrink=max_shrink, steps_per_call=steps_per_call,
        )
        super().__init__(init_fn, step_fn, initial_positions, seed)


class SliceSampler(_KernelSampler):
    """Coordinate-wise slice sampler (Neal 2003) — beyond-reference,
    gradient-free and self-tuning.

    One step = one full coordinate sweep (the ``GibbsSampler`` convention),
    but only ``target.logp`` is needed — no full conditionals and no
    proposal scale to tune: the stepping-out/shrinkage bracket adapts to
    the local slice every update, so the stationary distribution is exact
    for ANY positive ``width`` (a bad width only costs iterations). All
    chains advance in lockstep; the data-dependent bracket loops are
    masked ``lax.while_loop``s over the whole batch (``ops/slice.py``).

    ``width``: initial bracket width, scalar or per-coordinate ``[D]`` —
    the target's marginal scale is a good choice — or ``"auto"``: the
    per-coordinate cross-chain std of ``initial_positions`` (the lockstep
    ensemble snapshot, like ``estimate_preconditioner``; coordinates
    whose ensemble spread is degenerate fall back to 1). Any positive
    width is exact; a bad one only costs bracket iterations. Initial
    positions must lie inside the support (``logp > -inf``).

    Example:
        >>> from mini_mcmc_tpu import SliceSampler, init_det
        >>> from mini_mcmc_tpu.models import gaussian2d
        >>> target = gaussian2d([0., 0.], [[1., 0.], [0., 1.]])
        >>> ss = SliceSampler(target, init_det(4, 2)).seed(42)
        >>> ss.run(1000, 100).shape
        (4, 1000, 2)
    """

    def __init__(self, target: Target, initial_positions, width=1.0,
                 max_stepouts: int = 8, max_shrink: int = 32,
                 seed: Optional[int] = None, steps_per_call: int = 1,
                 transform=None):
        self.target = target
        self.transform = transform
        # transform: the bracket walks the unconstrained space, so the
        # "auto" width must measure the ensemble spread THERE
        kernel_target, positions_map, initial_positions = (
            _wrap_sampler_target(target, initial_positions, transform, None)
        )
        if isinstance(width, str):
            if width != "auto":
                raise ValueError(
                    f'width must be positive or "auto", got {width!r}'
                )
            spread = jnp.std(jnp.asarray(initial_positions), axis=0)
            width = jnp.where(spread > 1e-6, spread, 1.0)
        self.width = width
        init_fn, step_fn = slice_kernel(
            kernel_target, width=width, max_stepouts=max_stepouts,
            max_shrink=max_shrink, steps_per_call=steps_per_call,
        )
        super().__init__(init_fn, step_fn, initial_positions, seed,
                         positions_map=positions_map)


class GibbsSampler(_KernelSampler):
    """Batched Gibbs sampler: one step = one full coordinate sweep
    (/root/reference/src/gibbs.rs:95-99).

    ``steps_per_call`` > 1 scans K sweeps per block call (run lengths must
    then be multiples of K), like the MH/HMC block kernels.
    """

    def __init__(self, conditional: Conditional, initial_positions,
                 seed: Optional[int] = None, steps_per_call: int = 1):
        self.conditional = conditional
        init_fn, step_fn = gibbs_kernel(conditional,
                                        steps_per_call=steps_per_call)
        super().__init__(init_fn, step_fn, initial_positions, seed)


class SGLD(_KernelSampler):
    """Stochastic-gradient Langevin dynamics (Welling & Teh 2011), with
    optional RMSProp preconditioning (pSGLD, Li et al. 2016) —
    beyond-reference, the minibatch sampler for datasets too large for a
    full-gradient step (``ops/sgmcmc.py``; the Rust reference's gradient
    samplers all require exact gradients, /root/reference/src/hmc.rs:36).

    ``grad_fn(positions [C, D], key) -> [C, D]`` supplies the stochastic
    gradient — build it with :func:`~mini_mcmc_tpu.minibatch_grad` (data
    subsampling, matmul-batched likelihood) or
    :func:`~mini_mcmc_tpu.ops.sgmcmc.target_grad` (full-batch unadjusted
    Langevin). ``step_size`` is a constant or an on-device schedule such as
    :func:`~mini_mcmc_tpu.polynomial_decay`. There is no accept/reject:
    bias is O(step_size), so anneal or keep it small; the tracker's
    ``p(accept)`` reads 1.0 by construction.

    Example:
        >>> import jax.numpy as jnp
        >>> from mini_mcmc_tpu import SGLD, minibatch_grad, init_det
        >>> data = jnp.linspace(-1., 1., 256)[:, None]  # [N, 1]
        >>> grad_fn = minibatch_grad(
        ...     lambda x: -0.5 * jnp.sum(x**2),              # prior
        ...     lambda x, b: -0.5 * jnp.sum((b - x)**2),     # batch loglike
        ...     data, batch_size=32)
        >>> sgld = SGLD(grad_fn, init_det(8, 1), step_size=1e-3, seed=42)
        >>> sgld.run(100, 100).shape
        (8, 100, 1)
    """

    def __init__(self, grad_fn, initial_positions, step_size,
                 seed: Optional[int] = None, temperature: float = 1.0,
                 preconditioner: Optional[str] = None,
                 rms_decay: float = 0.99, rms_eps: float = 1e-5,
                 steps_per_call: int = 1):
        from .ops.sgmcmc import sgld_kernel

        self.grad_fn = grad_fn
        self.step_size = step_size
        init_fn, step_fn = sgld_kernel(
            grad_fn, step_size, temperature=temperature,
            preconditioner=preconditioner, rms_decay=rms_decay,
            rms_eps=rms_eps, steps_per_call=steps_per_call,
        )
        super().__init__(init_fn, step_fn, initial_positions, seed)


class SGHMC(_KernelSampler):
    """Stochastic-gradient Hamiltonian Monte Carlo (Chen, Fox & Guestrin
    2014) — beyond-reference, the friction-damped momentum variant of
    :class:`SGLD` (``ops/sgmcmc.py``).

    Same ``grad_fn``/``step_size`` contract as :class:`SGLD`; ``friction``
    (alpha, in (0, 1]) must dominate the minibatch gradient-noise scale —
    0.01..0.1 typical. Momenta start at zero; discard at least
    ``~1/friction`` steps for them to equilibrate.

    Example:
        >>> from mini_mcmc_tpu import SGHMC, init_det
        >>> from mini_mcmc_tpu.models import gaussian2d
        >>> from mini_mcmc_tpu.ops.sgmcmc import target_grad
        >>> target = gaussian2d([0., 0.], [[1., 0.], [0., 1.]])
        >>> s = SGHMC(target_grad(target), init_det(8, 2),
        ...           step_size=0.05, friction=0.1, seed=42)
        >>> s.run(200, 100).shape
        (8, 200, 2)
    """

    def __init__(self, grad_fn, initial_positions, step_size,
                 seed: Optional[int] = None, friction: float = 0.1,
                 temperature: float = 1.0, steps_per_call: int = 1):
        from .ops.sgmcmc import sghmc_kernel

        self.grad_fn = grad_fn
        self.step_size = step_size
        self.friction = friction
        init_fn, step_fn = sghmc_kernel(
            grad_fn, step_size, friction=friction, temperature=temperature,
            steps_per_call=steps_per_call,
        )
        super().__init__(init_fn, step_fn, initial_positions, seed)
