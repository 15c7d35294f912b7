"""Adaptive sequential Monte Carlo sampler (Del Moral et al. 2006).

Beyond-reference capability: the self-tuning sibling of :mod:`ops.ais`.
Where AIS walks a FIXED temperature schedule and reports a weight-ESS
diagnostic after the fact, the SMC sampler CHOOSES each temperature
increment on the fly — the next ``beta`` is the largest one keeping the
incremental importance weights' effective sample size at a target
fraction (the standard adaptive-tempering rule, solved by in-graph
bisection) — then systematically resamples the population back to uniform
weights and rejuvenates it with tempered MH moves. No schedule to
hand-tune: hard targets automatically get more, smaller steps.

The normalizing-constant estimate accumulates one self-normalized
increment per stage,

    log Z = sum_j [ logsumexp(dw_j) - log N ],
    dw_j = (beta_{j+1} - beta_j) * (logp(x) - logp0(x)),

which is unbiased in expectation under multinomial resampling and
near-unbiased (strictly lower variance) under the systematic scheme used
here (Del Moral et al. 2006, sec. 3.2).

Batched design: one ``lax.while_loop`` over stages, every stage a
fixed-shape lockstep program — a 40-iteration scalar bisection for the
next beta (skipped via ``lax.cond`` when the full jump to 1 already
passes), a systematic resample (a device-local gather), and batched MH
sweeps. The prior algebra, tempered-MH sweep, and resampling strata are
IMPORTED from ``ops/ais.py`` — one implementation, two estimators.
Unlike the sampling scans, adaptivity is irreducibly collective: choosing
beta from the population ESS reduces across particles inside the loop
(scalar all-reduces — the same class of collective as the tracked
progress scan, ``runner.py``). Fixed-size ``[max_stages]`` diagnostic
buffers keep shapes static; the host trims them to the realized stage
count afterwards.

Reference anchor: shares the tempered-density algebra of
``ops/tempering.py`` / ``ops/ais.py``; the Rust reference has no SMC.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..models.base import Target
from .ais import (
    _STRATA_CAP,
    _gaussian_prior,
    _make_tempered_mh,
    _resolve_key,
    _systematic_indices,
)


class SMCResult(NamedTuple):
    #: accumulated log normalizing-constant estimate
    log_z: jax.Array
    #: [N, D] final particle population (approximately target-distributed,
    #: uniformly weighted — resampling happens every stage)
    positions: jax.Array
    #: realized number of tempering stages (Python int)
    n_stages: int
    #: [n_stages] the adaptive schedule actually taken (ends at 1.0)
    betas: jax.Array
    #: [n_stages] incremental-weight ESS fraction at each stage (the
    #: bisection pins this at ``target_ess`` except for the final jump)
    stage_ess: jax.Array


def make_smc_run(
    target: Target,
    *,
    n_mh_steps: int = 5,
    proposal_std=0.5,
    prior_mean=0.0,
    prior_std=1.0,
    target_ess: float = 0.8,
    max_stages: int = 256,
):
    """Build the jitted adaptive anneal ``(x0 [N, D], key) ->
    (x, final_beta, log_z, n_stages, betas_buf, ess_buf)``.

    The reusable core of :func:`smc_log_z`: jit caching is keyed on the
    function object, so a fresh ``smc_log_z`` call re-traces — for seed
    studies or repeated runs of one configuration, build this once and
    call it many times (``bench.py`` does). ``x0`` MUST be distributed as
    the ``N(prior_mean, diag(prior_std^2))`` prior. ``betas_buf`` /
    ``ess_buf`` are ``[max_stages]`` NaN-padded; slice with ``n_stages``.
    A stalled anneal (float32 cannot represent a small-enough beta
    increment) parks at ``n_stages == max_stages`` with ``final_beta <
    1`` — :func:`smc_log_z` turns both into errors.
    """
    if n_mh_steps < 0:
        raise ValueError(f"n_mh_steps must be >= 0, got {n_mh_steps}")
    if not 0.0 < target_ess < 1.0:
        raise ValueError(f"target_ess must be in (0, 1), got {target_ess}")
    if max_stages < 1:
        raise ValueError(f"max_stages must be >= 1, got {max_stages}")
    sigma = jnp.atleast_1d(jnp.asarray(proposal_std, jnp.float32))
    tgt = jnp.float32(target_ess)

    @jax.jit
    def run(x0, k_loop):
        n_particles = x0.shape[0]
        n_f = jnp.float32(n_particles)
        log_n = jnp.log(n_f)
        _, _, prior_logp = _gaussian_prior(
            prior_mean, prior_std, x0.shape[1]
        )
        sweeps = _make_tempered_mh(target, prior_logp, sigma, n_mh_steps)

        def _ess_frac(dw):
            """Normalized ESS in (0, 1] of incremental log weights [N]."""
            w = jax.nn.softmax(dw)
            return 1.0 / (n_f * jnp.sum(w * w))

        lp_t0 = target.batch_logp(x0)
        lp_p0 = prior_logp(x0)

        def stage(carry):
            (x, lp_t, lp_p, beta, log_z, k, j, stalled,
             betas_buf, ess_buf) = carry
            k, k_res, k_mh = jax.random.split(k, 3)
            delta = lp_t - lp_p  # [N]

            # Next beta: the largest b in (beta, 1] whose incremental
            # weights keep ESS >= target_ess. The 40-iteration bisection
            # (40 cross-particle reductions) only runs when the full jump
            # to 1 fails its single ESS check.
            full = _ess_frac((1.0 - beta) * delta) >= tgt

            def bisect_beta(_):
                def bisect(_, lo_hi):
                    lo, hi = lo_hi
                    mid = 0.5 * (lo + hi)
                    ok = _ess_frac((mid - beta) * delta) >= tgt
                    return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

                lo, _ = jax.lax.fori_loop(
                    0, 40, bisect, (beta, jnp.float32(1.0))
                )
                return lo

            new_beta = jax.lax.cond(
                full, lambda _: jnp.float32(1.0), bisect_beta, None
            )
            # Stall: one float32 ulp of beta already drops ESS below the
            # target, so the bisection converged back to beta. Without
            # this flag the loop would spin max_stages zero-progress
            # stages of full compute before erroring.
            stalled = ~full & (new_beta <= beta)

            dw = (new_beta - beta) * delta
            log_z = log_z + jax.scipy.special.logsumexp(dw) - log_n
            betas_buf = betas_buf.at[j].set(new_beta)
            ess_buf = ess_buf.at[j].set(_ess_frac(dw))

            # Systematic resample back to uniform weights (device-local
            # gather; strata shared with ais.resample).
            idx = _systematic_indices(dw, k_res, n_particles, n_particles)
            x, lp_t, lp_p = x[idx], lp_t[idx], lp_p[idx]

            # Tempered-MH rejuvenation at the NEW beta.
            x, lp_t, lp_p = sweeps(x, lp_t, lp_p, new_beta, k_mh)
            return (x, lp_t, lp_p, new_beta, log_z, k, j + 1, stalled,
                    betas_buf, ess_buf)

        def cond(carry):
            beta, j, stalled = carry[3], carry[6], carry[7]
            return (beta < 1.0) & (j < max_stages) & ~stalled

        carry0 = (
            x0, lp_t0, lp_p0, jnp.float32(0.0), jnp.float32(0.0),
            k_loop, jnp.int32(0), jnp.bool_(False),
            jnp.full((max_stages,), jnp.nan, jnp.float32),
            jnp.full((max_stages,), jnp.nan, jnp.float32),
        )
        out = jax.lax.while_loop(cond, stage, carry0)
        x, _, _, beta, log_z, _, j, _, betas_buf, ess_buf = out
        return x, beta, log_z, j, betas_buf, ess_buf

    return run


def smc_log_z(
    target: Target,
    n_particles: int,
    dim: int,
    *,
    n_mh_steps: int = 5,
    proposal_std=0.5,
    prior_mean=0.0,
    prior_std=1.0,
    target_ess: float = 0.8,
    max_stages: int = 256,
    seed: Optional[int] = None,
    key: Optional[jax.Array] = None,
) -> SMCResult:
    """Estimate ``log Z`` of an unnormalized ``target`` by adaptive SMC.

    Args:
        target: the unnormalized target (``batch_logp`` is used).
        n_particles: population size N.
        dim: target dimension D.
        n_mh_steps: tempered-MH rejuvenation sweeps per stage.
        proposal_std: MH random-walk scale (scalar or per-dimension [D]).
        prior_mean / prior_std: the normalized Gaussian prior (as in
            :func:`ops.ais.ais_log_z`).
        target_ess: ESS fraction in (0, 1) each adaptive increment aims
            for — smaller = greedier (fewer, larger steps). The defaults
            (0.8, 5 MH sweeps) were tuned so a 4-sigma prior-target
            mismatch estimates within ~0.05 nats; NOTE that ``stage_ess``
            cannot see MH mixing failure (the log of an unbiased product
            estimator biases LOW by half its accumulated relative
            variance, measured -0.15 nats at target_ess=0.5 with 3
            sweeps on that target). If estimates drift across seeds,
            raise ``n_mh_steps`` / ``target_ess``, not just N.
        max_stages: hard cap on stages (the while loop's static bound);
            reaching it raises, since a truncated anneal biases log Z.
        seed / key: PRNG seeding (exactly one; ``seed`` defaults to 0).

    Each call builds (and jit-traces) a fresh program; for repeated runs
    of one configuration, build once with :func:`make_smc_run`.
    """
    if n_particles < 2:
        raise ValueError(f"n_particles must be >= 2, got {n_particles}")
    if n_particles > _STRATA_CAP:
        raise ValueError(
            f"n_particles={n_particles} exceeds the float32 resampling-"
            f"strata resolution (2^24 = {_STRATA_CAP})"
        )
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")
    key = _resolve_key(seed, key)
    mean, std, _ = _gaussian_prior(prior_mean, prior_std, dim)

    run = make_smc_run(
        target, n_mh_steps=n_mh_steps, proposal_std=proposal_std,
        prior_mean=prior_mean, prior_std=prior_std,
        target_ess=target_ess, max_stages=max_stages,
    )
    k_init, k_loop = jax.random.split(key)
    x0 = mean + std * jax.random.normal(
        k_init, (n_particles, dim), jnp.float32
    )
    x, beta, log_z, j, betas_buf, ess_buf = run(x0, k_loop)
    n_stages = int(j)
    if float(beta) < 1.0:
        if n_stages < max_stages:
            raise RuntimeError(
                f"SMC anneal stalled at beta={float(beta):.6g}: one "
                "float32 ulp of beta already drops the incremental ESS "
                "below target_ess (the target's logp spread is too large "
                "for a float32 anneal) — rescale the problem or lower "
                "target_ess"
            )
        raise RuntimeError(
            f"SMC hit max_stages={max_stages} at beta={float(beta):.6f} "
            f"< 1 — the anneal is truncated and log_z would be biased; "
            f"raise max_stages, or LOWER target_ess for greedier steps"
        )
    return SMCResult(
        log_z=log_z,
        positions=x,
        n_stages=n_stages,
        betas=betas_buf[:n_stages],
        stage_ess=ess_buf[:n_stages],
    )
