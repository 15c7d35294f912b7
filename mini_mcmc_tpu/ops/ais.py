"""Annealed importance sampling (Neal 2001): normalizing constants.

Beyond-reference capability (the Rust reference stops at sampling): the
standard estimator for the normalizing constant ``Z = ∫ exp(logp(x)) dx``
of an unnormalized target — the quantity model comparison (Bayes factors,
marginal likelihoods) needs and plain MCMC cannot produce.

AIS anneals a population of particles from a tractable, NORMALIZED prior
``p0`` to the target along the geometric path

    f_beta(x) ∝ exp((1 - beta) * logp0(x) + beta * logp(x)),

``0 = beta_0 < beta_1 < ... < beta_K = 1``, applying a few
``f_beta``-invariant MH steps at each rung and accumulating the importance
weight

    log w = sum_k (beta_k - beta_{k-1}) * (logp(x_{k-1}) - logp0(x_{k-1})),

evaluated at the particle BEFORE the rung's transition (Neal 2001 eq. 11).
Because ``p0`` is normalized, ``E[w] = Z`` exactly for ANY rung count and
ANY number of MH steps — the schedule controls variance, never bias — and
``logsumexp(log_w) - log N`` is a consistent (slightly conservative,
Jensen-biased-low) estimator of ``log Z``.

Batched design: the particle population is one ``[N, D]`` lockstep
batch (the same batched-MH update as ``ops/mh.py``), the anneal is a
single ``lax.scan`` over a static rung schedule — one compiled program,
zero host round-trips, and nothing reduces across particles inside the
scan, so the particle axis shards like a chain axis (weights are combined
once, at the end: a single ``logsumexp``). This is the same ladder
machinery as ``ops/tempering.py`` run SEQUENTIALLY (one moving inverse
temperature) instead of in parallel (a static ladder with swaps).

The Gaussian-prior algebra, tempered-MH sweep, and systematic-resampling
strata here are the shared building blocks of the adaptive sampler too
(``ops/smc.py`` imports them) — fix them HERE, not in a copy.

Reference anchor: the tempered-density algebra mirrors
``ops/tempering.py``; the reference crate has no AIS to cite.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import jax
import jax.numpy as jnp

from ..models.base import Target

#: float32 strata (``(u + arange(n)) / n``) collapse above 2^24 — distinct
#: strata would repeat, silently double-drawing some particles. Guarded in
#: every systematic-resampling call site.
_STRATA_CAP = 1 << 24


class AISResult(NamedTuple):
    #: consistent log-Z estimate: logsumexp(log_weights) - log N
    log_z: jax.Array
    #: [N] per-particle log importance weights (E[exp] = Z, unbiased)
    log_weights: jax.Array
    #: [N, D] final particle positions (approximately target-distributed;
    #: resample by normalized weight for exact importance resampling)
    positions: jax.Array
    #: normalized importance-weight effective sample size in (0, 1]:
    #: (sum w)^2 / (N * sum w^2). Low values mean the schedule is too
    #: coarse (add rungs / MH steps) — the variance diagnostic to gate on.
    weight_ess: jax.Array


def linear_betas(n_rungs: int) -> tuple:
    """The default anneal schedule: ``n_rungs`` equal steps ``0 -> 1``."""
    if n_rungs < 1:
        raise ValueError(f"n_rungs must be >= 1, got {n_rungs}")
    return tuple(float(b) for b in jnp.linspace(0.0, 1.0, n_rungs + 1)[1:])


def _validate_betas(betas) -> tuple:
    """Shared schedule validation: strictly increasing, ends at 1.0
    (``beta_0 = 0`` implicit). Used by every entry point that accepts a
    schedule — a wrong bridge density returns silently wrong weights."""
    betas = tuple(float(b) for b in betas)
    if not betas or abs(betas[-1] - 1.0) > 1e-12:
        raise ValueError(f"betas must end at 1.0, got {betas!r}")
    if any(b2 <= b1 for b1, b2 in zip((0.0,) + betas, betas)):
        raise ValueError("betas must be strictly increasing in (0, 1], "
                         f"got {betas!r}")
    return betas


def _resolve_key(seed, key):
    if key is None:
        return jax.random.PRNGKey(0 if seed is None else seed)
    if seed is not None:
        raise ValueError("pass seed or key, not both")
    return key


def _gaussian_prior(prior_mean, prior_std, dim: int):
    """Validated NORMALIZED Gaussian prior: ``(mean [D], std [D],
    prior_logp: [N, D] -> [N])``. The ``log_norm`` constants are load-
    bearing — they are what make ``E[w] = Z`` rather than ``Z/Z_prior``.
    Validation and constants use host numpy so the helper works both
    eagerly and inside a jit trace (jnp constants become tracers there)."""
    import numpy as np

    mean_h = np.broadcast_to(np.asarray(prior_mean, np.float32), (dim,))
    std_h = np.broadcast_to(np.asarray(prior_std, np.float32), (dim,))
    if np.any(std_h <= 0):
        raise ValueError(f"prior_std must be positive, got {prior_std!r}")
    log_norm = float(
        -0.5 * dim * np.log(2.0 * np.pi) - np.sum(np.log(std_h))
    )
    mean = jnp.asarray(mean_h)
    std = jnp.asarray(std_h)

    def prior_logp(xs):  # [N, D] -> [N]
        return log_norm - 0.5 * jnp.sum(((xs - mean) / std) ** 2, axis=-1)

    return mean, std, prior_logp


def _make_tempered_mh(target: Target, prior_logp, sigma, n_mh_steps: int):
    """``f_beta``-invariant random-walk MH sweeps, shared by AIS and SMC:
    ``sweeps(x, lp_t, lp_p, beta, key) -> (x, lp_t, lp_p)``."""

    def sweeps(x, lp_t, lp_p, beta, key):
        def mh(carry, sub):
            x, lp_t, lp_p = carry
            kp, ku = jax.random.split(sub)
            prop = x + sigma * jax.random.normal(kp, x.shape, x.dtype)
            plp_t = target.batch_logp(prop)
            plp_p = prior_logp(prop)
            log_acc = ((1.0 - beta) * (plp_p - lp_p)
                       + beta * (plp_t - lp_t))
            u = jax.random.uniform(ku, log_acc.shape, log_acc.dtype)
            acc = log_acc > jnp.log(u)
            return (
                jnp.where(acc[:, None], prop, x),
                jnp.where(acc, plp_t, lp_t),
                jnp.where(acc, plp_p, lp_p),
            ), None

        if n_mh_steps > 0:  # static: jax.random.split rejects num=0
            (x, lp_t, lp_p), _ = jax.lax.scan(
                mh, (x, lp_t, lp_p), jax.random.split(key, n_mh_steps)
            )
        return x, lp_t, lp_p

    return sweeps


def _systematic_indices(log_w, key, n: int, n_draws: int):
    """Stratified inverse-CDF indices of the systematic resampling scheme
    (one uniform, ``n_draws`` equal strata). Traceable; callers guard
    ``n_draws <= _STRATA_CAP`` eagerly."""
    w = jax.nn.softmax(log_w)
    cdf = jnp.cumsum(w)
    u = (jax.random.uniform(key, (), w.dtype)
         + jnp.arange(n_draws, dtype=w.dtype)) / n_draws
    return jnp.clip(jnp.searchsorted(cdf, u), 0, n - 1)


def ais_log_z(
    target: Target,
    n_particles: int,
    dim: int,
    *,
    betas: Union[int, Sequence[float]] = 64,
    n_mh_steps: int = 2,
    proposal_std=0.5,
    prior_mean=0.0,
    prior_std=1.0,
    seed: Optional[int] = None,
    key: Optional[jax.Array] = None,
) -> AISResult:
    """Estimate ``log Z`` of an unnormalized ``target`` by AIS.

    Args:
        target: the unnormalized target (``batch_logp`` is used).
        n_particles: population size N (one lockstep ``[N, D]`` batch).
        dim: target dimension D.
        betas: an int (rung count for the default linear schedule) or an
            explicit increasing schedule ending at 1.0 (``beta_0 = 0`` is
            implicit). More rungs = lower weight variance, same mean.
        n_mh_steps: ``f_beta``-invariant random-walk MH steps per rung.
        proposal_std: MH random-walk scale (scalar or per-dimension [D]).
        prior_mean / prior_std: the normalized Gaussian prior
            ``N(prior_mean, diag(prior_std^2))`` (scalar or [D] each).
            Center it on the target's bulk — AIS is exact for any choice,
            but a distant prior needs a finer schedule.
        seed / key: PRNG seeding (exactly one; ``seed`` defaults to 0).

    Returns an :class:`AISResult`. Check ``weight_ess`` before trusting
    ``log_z`` — a collapsed ESS means one particle dominates the estimate.

    Each call builds (and jit-traces) a fresh anneal program; for repeated
    estimates of the same configuration — seed studies, sharded runs —
    build once with :func:`make_anneal` and reuse it.
    """
    if n_particles < 2:
        raise ValueError(f"n_particles must be >= 2, got {n_particles}")
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")
    if isinstance(betas, int):
        betas = linear_betas(betas)
    key = _resolve_key(seed, key)
    mean, std, _ = _gaussian_prior(prior_mean, prior_std, dim)

    k_init, k_scan = jax.random.split(key)
    x0 = mean + std * jax.random.normal(
        k_init, (n_particles, dim), jnp.float32
    )

    anneal = make_anneal(target, betas, n_mh_steps=n_mh_steps,
                         proposal_std=proposal_std, prior_mean=prior_mean,
                         prior_std=prior_std)
    betas = _validate_betas(betas)
    rung_keys = jax.random.split(k_scan, len(betas))
    x, log_w = anneal(x0, rung_keys)
    # The ONLY cross-particle reductions, once, outside the anneal scan —
    # the scan itself compiles to zero collectives over a sharded particle
    # axis (pinned by tests/test_parallel.py).
    log_z = jax.scipy.special.logsumexp(log_w) - jnp.log(
        jnp.float32(n_particles)
    )
    w = jnp.exp(log_w - jnp.max(log_w))
    ess = jnp.sum(w) ** 2 / (n_particles * jnp.sum(w * w))
    return AISResult(log_z, log_w, x, ess)


def resample(log_weights, positions, key, n_draws: Optional[int] = None):
    """Systematic importance resampling: weighted particles -> an
    unweighted ``[n_draws, D]`` sample of the target.

    The standard low-variance scheme (one uniform, stratified inverse-CDF
    lookup): particle i is drawn ``floor(N * W_i + u)`` or one more times,
    so resampling noise is strictly smaller than multinomial sampling's.
    Use on :class:`AISResult`'s ``(log_weights, positions)`` when
    downstream code needs plain draws rather than a weighted population;
    duplicates are expected wherever the weight ESS is below 1.
    """
    log_w = jnp.asarray(log_weights)
    n = log_w.shape[0]
    if n_draws is None:
        n_draws = n
    if n_draws < 1:
        raise ValueError(f"n_draws must be >= 1, got {n_draws}")
    if n_draws > _STRATA_CAP:
        raise ValueError(
            f"n_draws={n_draws} exceeds the float32 strata resolution "
            f"(2^24 = {_STRATA_CAP}): distinct strata would collapse and "
            "silently double-draw particles. Resample in <= 2^24 blocks."
        )
    idx = _systematic_indices(log_w, key, n, n_draws)
    return jnp.asarray(positions)[idx]


def make_anneal(
    target: Target,
    betas: Sequence[float],
    *,
    n_mh_steps: int = 2,
    proposal_std=0.5,
    prior_mean=0.0,
    prior_std=1.0,
):
    """Build the jitted anneal scan ``(x0 [N, D], rung_keys [K]) ->
    (x [N, D], log_weights [N])``.

    The embarrassingly-parallel core of :func:`ais_log_z`, exposed so the
    particle batch can be sharded over a mesh AND so the traced program
    can be reused across calls (a fresh ``ais_log_z`` call re-traces):
    nothing inside reduces across particles (the log-Z ``logsumexp``
    happens outside, once), so the compiled SPMD program contains no
    collective ops and scales linearly over chips — same invariant as the
    sampling scans, pinned by ``tests/test_parallel.py``. ``x0`` MUST be
    distributed as the ``N(prior_mean, diag(prior_std^2))`` prior for the
    weights to mean anything.
    """
    betas = _validate_betas(betas)
    if n_mh_steps < 0:
        raise ValueError(f"n_mh_steps must be >= 0, got {n_mh_steps}")
    sigma = jnp.atleast_1d(jnp.asarray(proposal_std, jnp.float32))
    beta_steps = jnp.asarray(betas, jnp.float32)
    dbeta = jnp.diff(
        jnp.concatenate([jnp.zeros(1, jnp.float32), beta_steps])
    )

    @jax.jit
    def anneal(x0, rung_keys):
        _, _, prior_logp = _gaussian_prior(
            prior_mean, prior_std, x0.shape[1]
        )
        sweeps = _make_tempered_mh(target, prior_logp, sigma, n_mh_steps)
        lp_t0 = target.batch_logp(x0)
        lp_p0 = prior_logp(x0)

        def rung(carry, inp):
            x, lp_t, lp_p, log_w = carry
            beta, d_beta, k = inp
            # Weight increment at the PRE-transition particle (Neal 2001):
            # log f_k(x_{k-1}) - log f_{k-1}(x_{k-1}) = d_beta*(lp_t-lp_p).
            log_w = log_w + d_beta * (lp_t - lp_p)
            x, lp_t, lp_p = sweeps(x, lp_t, lp_p, beta, k)
            return (x, lp_t, lp_p, log_w), None

        carry0 = (
            x0, lp_t0, lp_p0, jnp.zeros(x0.shape[0], jnp.float32)
        )
        (x, _, _, log_w), _ = jax.lax.scan(
            rung, carry0, (beta_steps, dbeta, rung_keys)
        )
        return x, log_w

    return anneal
