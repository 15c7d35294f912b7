"""Modern (rank-normalized) convergence diagnostics — beyond-reference.

`stats.py` replicates the reference's Stan-2017-era formulas bit-for-bit,
quirks included, because ESS/R-hat parity with
/root/reference/src/stats.rs:416-546 is a stated goal. This module adds the
CURRENT recommended diagnostics (Vehtari, Gelman, Simpson, Carpenter,
Burkner, 2021: "Rank-normalization, folding, and localization: an improved
R-hat for assessing convergence of MCMC"), which the reference does not
have:

- **rank-normalized split R-hat** — robust to heavy tails (classic R-hat
  silently breaks when moments don't exist) and, via **folding**, sensitive
  to chains that agree in location but differ in scale;
- **bulk ESS** — ESS of the rank-normalized draws (center-of-distribution
  mixing);
- **tail ESS** — ESS of the 5%/95% quantile exceedance indicators
  (tail-quantile reliability, what credible intervals depend on).

Unlike the parity module this uses the STANDARD split R-hat orientation
``sqrt(var_hat / W)`` (values >= 1, flag above ~1.01) — the reference's
inverted ``sqrt(W / var)`` quirk is deliberately not carried over here.

All transforms are batched jnp ops (one argsort-based ranking per
parameter, normal quantiles via ``ndtri``), so the diagnostics run
on-device over the full ``[C, N, P]`` cube; per-parameter ranking sorts
``C*N`` elements, so for flagship-scale cubes run this at analysis time
(it allocates rank/z copies of the cube), not inside a sampling loop.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from .stats import _ess, _splitcat, _withinvar


def _rank_normalize_pm(flat_pm: jax.Array) -> jax.Array:
    """Fractional-offset rank-normalization of ``[P, S]`` draws -> z-scores.

    Ordinal ranks via double argsort (ties are measure-zero for continuous
    float draws), then the Blom-offset normal quantile
    ``z = Phi^-1((r + 1 - 3/8) / (S + 1/4))`` (Vehtari et al. 2021, eq. 14).

    Layout: parameters-major, draws on the MINOR axis, so all big sorts
    here run along the long contiguous draws axis rather than a tiny
    minor parameter axis.
    """
    s = flat_pm.shape[1]
    order = jnp.argsort(flat_pm, axis=1)
    ranks = jnp.argsort(order, axis=1).astype(jnp.float32)  # 0-based
    u = (ranks + (1.0 - 0.375)) / (s + 0.25)
    return jax.scipy.special.ndtri(u).astype(jnp.float32)


def _rank_normalize_cube(sample: jax.Array) -> jax.Array:
    """Rank-normalize a ``[C, N, P]`` cube over ALL draws per parameter."""
    c, n, p = sample.shape
    pm = jnp.transpose(sample, (2, 0, 1)).reshape(p, c * n)
    z = _rank_normalize_pm(pm)
    return jnp.transpose(z.reshape(p, c, n), (1, 2, 0))


def _standard_split_rhat(splitted: jax.Array) -> jax.Array:
    """STANDARD-orientation split R-hat ``sqrt(var_hat / W)`` on a
    ``[2C, n', P]`` split cube (>= 1; the parity module's quirk inverts
    it)."""
    within, var = _withinvar(splitted)
    return jnp.sqrt(var / within)


def _split_rhat_and_ess(cube: jax.Array):
    splitted = _splitcat(cube)
    within, var = _withinvar(splitted)
    rhat = jnp.sqrt(var / within)  # = _standard_split_rhat(splitted)
    ess = _ess(splitted, within, var)
    return rhat, ess


@dataclasses.dataclass
class ModernDiagnostics:
    """Per-parameter rank-normalized diagnostics (arrays of shape ``[P]``).

    ``rhat`` is ``max(bulk rank-normalized R-hat, folded rank-normalized
    R-hat)`` — the quantity Stan reports; flag parameters above ~1.01.
    """

    rhat: jax.Array
    rhat_bulk: jax.Array
    rhat_folded: jax.Array
    ess_bulk: jax.Array
    ess_tail: jax.Array

    def __str__(self) -> str:
        return (
            f"rank-normalized R-hat in [{float(jnp.min(self.rhat)):.4f}, "
            f"{float(jnp.max(self.rhat)):.4f}], "
            f"bulk ESS >= {float(jnp.min(self.ess_bulk)):.1f}, "
            f"tail ESS >= {float(jnp.min(self.ess_tail)):.1f}"
        )


@partial(jax.jit, static_argnames=())
def _diagnostics_impl(sample: jax.Array):
    """Jitted core over a chain-major ``[C, N, P]`` cube.

    One compiled program: XLA fuses the transposes/slices and frees
    intermediates, where eager op-by-op dispatch materialized every
    temporary (the flagship-scale peak memory this layout exists to
    avoid).
    """
    c, n, p = sample.shape
    pm = jnp.transpose(sample, (2, 0, 1)).reshape(p, c * n)  # [P, S]

    # bulk: rank-normalize all draws, then standard split R-hat + ESS
    z = _rank_normalize_cube(sample)
    rhat_bulk, ess_bulk = _split_rhat_and_ess(z)

    # folded: rank-normalize |x - median| — detects scale disagreement
    # between chains that classic (mean-based) R-hat cannot see
    median = jnp.quantile(pm, 0.5, axis=1)  # [P]
    folded = jnp.abs(sample - median[None, None, :])
    z_fold = _rank_normalize_cube(folded)
    rhat_folded = _standard_split_rhat(_splitcat(z_fold))

    # tail: ESS of the RAW 5% / 95% exceedance indicators (Vehtari et al.
    # sec. 4.3 — the indicator is already bounded, so no rank transform;
    # rank-normalizing a two-valued array would turn argsort tie order
    # into a spurious time ramp and collapse the ESS)
    q05 = jnp.quantile(pm, 0.05, axis=1)
    q95 = jnp.quantile(pm, 0.95, axis=1)
    ess_tails = []
    for ind in (
        (sample <= q05[None, None, :]),
        (sample >= q95[None, None, :]),
    ):
        splitted = _splitcat(ind.astype(jnp.float32))
        within, var = _withinvar(splitted)
        ess_tails.append(_ess(splitted, within, var))
    ess_tail = jnp.minimum(*ess_tails)
    return rhat_bulk, rhat_folded, ess_bulk, ess_tail


@dataclasses.dataclass
class Summary:
    """Per-parameter posterior summary table (arrays of shape ``[P]``,
    ``quantiles`` of shape ``[Q, P]``). ``str()`` renders the aligned
    table; iterate ``names`` for the row order."""

    names: tuple
    mean: jax.Array
    sd: jax.Array
    mcse_mean: jax.Array
    mcse_sd: jax.Array
    q_levels: tuple
    quantiles: jax.Array
    ess_bulk: jax.Array
    ess_tail: jax.Array
    rhat: jax.Array

    def __str__(self) -> str:
        header = (["parameter", "mean", "sd", "mcse_mean", "mcse_sd"]
                  + [f"q{100 * q:g}" for q in self.q_levels]
                  + ["ess_bulk", "ess_tail", "rhat"])
        rows = [header]
        for i, name in enumerate(self.names):
            rows.append(
                [name]
                + [f"{float(a[i]):.3f}" for a in
                   (self.mean, self.sd, self.mcse_mean, self.mcse_sd)]
                + [f"{float(self.quantiles[j, i]):.3f}"
                   for j in range(len(self.q_levels))]
                + [f"{float(self.ess_bulk[i]):.0f}",
                   f"{float(self.ess_tail[i]):.0f}",
                   f"{float(self.rhat[i]):.4f}"]
            )
        widths = [max(len(r[c]) for r in rows) for c in range(len(header))]
        return "\n".join(
            "  ".join(cell.rjust(w) for cell, w in zip(r, widths))
            for r in rows
        )


def summary(sample: jax.Array, *, quantiles=(0.05, 0.5, 0.95),
            param_names=None, time_major: bool = False) -> Summary:
    """One-stop posterior summary: mean, sd, Monte-Carlo standard errors,
    quantiles, bulk/tail ESS, and rank-normalized R-hat per parameter —
    the analysis-time report (the arviz ``summary`` analog; the
    reference's closest surface is ``RunStats``'s ESS/R-hat pair,
    /root/reference/src/stats.rs:339-371).

    MCSE of the mean is ``sd / sqrt(ess_bulk)``; MCSE of the sd uses the
    Vehtari et al. (2021) approximation with ``ess_sd = min(ess(x),
    ess(x^2))``. Both are Monte-Carlo (sampling) errors, not posterior
    uncertainty.

    Args:
        sample: ``[chains, observations, parameters]`` cube (or
            time-major with ``time_major=True``).
        quantiles: posterior quantile levels to report.
        param_names: ``[P]`` row labels (default ``x0..x{P-1}``).
    """
    sample = jnp.asarray(sample, jnp.float32)
    if sample.ndim != 3:
        raise ValueError(
            f"sample must be a 3-D cube; got shape {sample.shape}"
        )
    if time_major:
        sample = jnp.swapaxes(sample, 0, 1)
    p = sample.shape[2]
    if param_names is None:
        param_names = tuple(f"x{i}" for i in range(p))
    param_names = tuple(param_names)
    if len(param_names) != p:
        raise ValueError(
            f"{len(param_names)} param_names for {p} parameters"
        )
    q_levels = tuple(float(q) for q in quantiles)

    diag = rank_normalized_diagnostics(sample)
    mean, sd, qs, ess_x, ess_x2 = _summary_impl(sample, q_levels)
    ess_sd = jnp.minimum(ess_x, ess_x2)
    mcse_mean = sd / jnp.sqrt(diag.ess_bulk)
    # Vehtari et al. 2021 app. A: sd's relative MC error from
    # ess_sd = min(ess(x), ess(x^2)), with
    # fac = e * (1 - 1/ess)^(ess-1) - 1 (~ 1/(2 ess) for large ess).
    # Computed as expm1(1 + (ess-1) log1p(-1/ess)): the naive power form
    # cancels catastrophically in float32 (rounds to 0 for ess ~ 1e4).
    # Clamp ess to just above 1 — at ess <= 1 the log1p term is -inf/NaN
    # and jnp.maximum would PROPAGATE the NaN; the clamped value yields
    # fac ~ e-1, i.e. mcse_sd ~ 1.3 sd, the honest "no information" answer.
    safe_ess = jnp.maximum(ess_sd, 1.0 + 1e-6)
    fac = jnp.expm1(1.0 + (safe_ess - 1.0) * jnp.log1p(-1.0 / safe_ess))
    mcse_sd = sd * jnp.sqrt(jnp.maximum(fac, 0.0))
    return Summary(
        names=param_names, mean=mean, sd=sd, mcse_mean=mcse_mean,
        mcse_sd=mcse_sd, q_levels=q_levels, quantiles=qs,
        ess_bulk=diag.ess_bulk, ess_tail=diag.ess_tail, rhat=diag.rhat,
    )


@partial(jax.jit, static_argnames=("q_levels",))
def _summary_impl(sample: jax.Array, q_levels: tuple):
    c, n, p = sample.shape
    pm = jnp.transpose(sample, (2, 0, 1)).reshape(p, c * n)  # [P, S]
    mean = jnp.mean(pm, axis=1)
    sd = jnp.std(pm, axis=1, ddof=1)
    qs = jnp.quantile(pm, jnp.asarray(q_levels), axis=1)  # [Q, P]
    # split-ESS of raw x and of x^2 for the sd's MCSE
    ess = []
    for cube in (sample, sample * sample):
        splitted = _splitcat(cube)
        within, var = _withinvar(splitted)
        ess.append(_ess(splitted, within, var))
    return mean, sd, qs, ess[0], ess[1]


def rank_normalized_diagnostics(
    sample: jax.Array, *, time_major: bool = False
) -> ModernDiagnostics:
    """Rank-normalized split R-hat, bulk ESS, and tail ESS per parameter.

    Args:
        sample: ``[chains, observations, parameters]`` cube (or
            ``[observations, chains, parameters]`` with ``time_major=True``;
            the rank transform allocates cube-sized temporaries either way,
            so the layout only affects the input convention here).

    Returns:
        :class:`ModernDiagnostics` with ``[P]`` arrays.
    """
    sample = jnp.asarray(sample, jnp.float32)
    if sample.ndim != 3:
        raise ValueError(
            f"sample must be a 3-D cube; got shape {sample.shape}"
        )
    if time_major:
        sample = jnp.swapaxes(sample, 0, 1)
    rhat_bulk, rhat_folded, ess_bulk, ess_tail = _diagnostics_impl(sample)
    return ModernDiagnostics(
        rhat=jnp.maximum(rhat_bulk, rhat_folded),
        rhat_bulk=rhat_bulk,
        rhat_folded=rhat_folded,
        ess_bulk=ess_bulk,
        ess_tail=ess_tail,
    )
