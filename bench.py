"""North-star benchmark: 3D Rosenbrock HMC at 65,536 chains per chip.

Measures effective samples per second per chip (ESS computed with the
framework's Stan-style split-R-hat/ESS, /root/reference/src/stats.rs:416-546
parity) against the BASELINE.json target of 1e6 ESS/sec/chip. Prints ONE
JSON line. A NUTS steady-state configuration is recorded as a secondary
metric in the ``detail`` block (the analog of the reference's NUTS
throughput harness, /root/reference/src/nuts.rs:1251-1281).

The benchmark is SELF-VALIDATING: each timed sample must pass a statistical
quality gate (split R-hat band, an ESS floor, and dim-0 moments pinned to
quadrature ground truth) before its throughput is reported — a
wrong-but-fast kernel regression fails the run instead of posting a
headline number. This mirrors the reference's asserted quality bands
(/root/reference/src/hmc.rs:764-787).

Config mirrors the reference harness family
(``examples/rosenbrock3d_hmc.rs``: RosenbrockND, HMC leapfrog) scaled to
65,536 chains; (step size, L) give a trajectory of ~3.8, which mixes the
Rosenbrock valley well.

Each timed region is ONE compiled scan dispatch per program signature, so
per-dispatch host latency is amortized to noise, and timing waits for the
result with ``jax.block_until_ready``.

Every BASELINE.json config is measured in the default run: the HMC
flagship headline plus NUTS steady state (with a
steady-state divergence gate), the 65,536-chain MH 2D-Gaussian
(minimal_mh.rs scaled to flagship chain count), the 65,536-chain mixture
Gibbs (mixture_gibbs.rs), the 65,536-chain Poisson discrete MH
(poisson_mh.rs), and d=10,000 HMC (hmc.rs:882-916) — each behind its own
quality gate, all folded into ``detail``. The beyond-reference
samplers (tuned MALA, ChEES-HMC, affine-invariant ensemble,
replica-exchange tempering, slice, elliptical slice, AIS/SMC evidence) are
measured and gated too, so their README numbers are artifact-backed.
``--extra`` is accepted for compatibility and adds nothing (everything is
already in the default run). The artifact records the device it ran on
(``backend``, ``device_kind``, ``device_count``); on a machine without a GPU
the bench refuses to run.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

from mini_mcmc_tpu import HMC, NUTS, init_with_seed, split_rhat_mean_ess
from mini_mcmc_tpu.models import diffable_gaussian2d, rosenbrock_nd

N_CHAINS = 65536  # time-major cube: 65,536 x 8,192 x 3 f32 = 6.4 GB
DIM = 3
STEP_SIZE = 0.02
N_LEAPFROG = 192
N_COLLECT = 8192  # burn-in happens via a first (discarded) collect run
JITTER = 0.3  # per-step step-size jitter: fixed (eps, L) resonances make
# ESS wildly seed-dependent on Rosenbrock; jitter stabilizes ESS to ~1%
# across seeds (Neal 2011)
BASELINE_ESS_PER_SEC = 1.0e6

# Ground truth for the Rosenbrock3D x0 marginal, by 1-D quadrature:
# integrating x2 then x1 out of exp(-sum 100(x_{i+1}-x_i^2)^2 + (1-x_i)^2)
# leaves f(x0) ∝ exp(-(1-x0)^2 - (100/101)(1-x0^2)^2).
ROSEN3D_X0_MEAN = 0.785217
ROSEN3D_X0_VAR = 0.229370

# NUTS secondary config: the reference quality-band target
# (DiffableGaussian2D([0,1],[[4,2],[2,3]]), hmc.rs:632-700 family),
# steady state after dual-averaging adaptation.
NUTS_CHAINS = 131072
NUTS_COLLECT = 2048
NUTS_DISCARD = 128
NUTS_MEAN = (0.0, 1.0)
NUTS_VAR = (4.0, 3.0)


def _gate(name, ok, info):
    # explicit raise, not `assert`: the gates must survive `python -O`
    if not ok:
        raise AssertionError(f"quality gate FAILED [{name}]: {info}")


def _timed_best(run_once, reps=3):
    """Time ``run_once`` (a steady-state, already-compiled dispatch)
    ``reps`` times and keep the fastest rep's ``(sample, elapsed)``.
    Min-of-reps drops host-side stalls (the host's cores are shared); any
    rep's sample is statistically valid (the chain just advanced between
    reps), so quality gates run on the kept one.

    At most ONE sample cube is held at any moment: the previous rep's
    cube is freed BEFORE the next dispatch, so peak memory is one cube,
    not two. The returned sample is the LAST rep's (any rep's sample is
    equally valid), paired with the fastest rep's elapsed."""
    best_e = float("inf")
    s = None
    for _ in range(reps):
        s = None  # free the previous cube before dispatching the next
        t0 = time.monotonic()
        s = jax.block_until_ready(run_once())
        e = time.monotonic() - t0
        best_e = min(best_e, e)
    return s, best_e


def bench_hmc_flagship() -> dict:
    target = rosenbrock_nd()
    # Start near the mode plateau for fast equilibration.
    init = init_with_seed(N_CHAINS, DIM, seed=42) * 0.5 + 1.0
    hmc = HMC(target, init, STEP_SIZE, N_LEAPFROG, jitter=JITTER).seed(42)

    # Burn-in with the SAME (n_collect, n_discard) signature as the timed
    # run: exactly one program is compiled. The first call's output is the
    # burn-in. time_major: scan-native [N, C, D] layout; skipping the cube
    # transpose halves peak device memory.
    t0 = time.monotonic()
    jax.block_until_ready(hmc.run(N_COLLECT, 0, time_major=True))
    first_call_s = time.monotonic() - t0

    # Timed region: steady-state sampling only, one compiled dispatch.
    sample, elapsed = _timed_best(
        lambda: hmc.run(N_COLLECT, 0, time_major=True))

    rhat, ess = split_rhat_mean_ess(sample, time_major=True)
    ess_mean = float(jnp.mean(ess))
    ess_min = float(jnp.min(ess))
    rhat_mean = float(jnp.mean(rhat))
    x0 = sample[:, :, 0]
    x0_mean = float(jnp.mean(x0))
    x0_var = float(jnp.var(x0))

    # Quality gate: the headline number is only posted for a statistically
    # correct sample.
    total_draws = N_CHAINS * N_COLLECT
    _gate("hmc rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("hmc ess floor", ess_min >= 0.01 * total_draws,
          (ess_min, total_draws))
    _gate("hmc x0 mean", abs(x0_mean - ROSEN3D_X0_MEAN) <= 0.05, x0_mean)
    _gate("hmc x0 var", abs(x0_var - ROSEN3D_X0_VAR) <= 0.04, x0_var)

    # Modern gate (beyond-reference, diagnostics.py): rank-normalized +
    # folded split R-hat — catches heavy-tail/scale pathologies classic
    # R-hat is blind to — over a 2,048-chain x 512-draw subsample
    # (subsampling does not bias R-hat).
    from mini_mcmc_tpu import rank_normalized_diagnostics

    # Contiguous slice, NOT a strided gather: a strided [::16, ::32] gather
    # over the 6.4 GB cube needs a cube-scale temporary. Chains are
    # exchangeable and the last 512 draws are the steady state, so a
    # contiguous [512, 2048, 3] block is an unbiased subsample.
    from jax import lax

    sub = lax.slice(sample, (N_COLLECT - 512, 0, 0), (N_COLLECT, 2048, DIM))
    modern = rank_normalized_diagnostics(sub, time_major=True)
    rank_rhat_max = float(jnp.max(modern.rhat))
    _gate("hmc rank-normalized rhat", rank_rhat_max <= 1.02, rank_rhat_max)

    steps_per_sec = N_COLLECT / elapsed
    grad_evals_per_sec = steps_per_sec * N_CHAINS * N_LEAPFROG
    return {
        "ess_per_sec": ess_mean / elapsed,
        "config": f"Rosenbrock3D HMC, {N_CHAINS} chains, "
        f"L={N_LEAPFROG}, eps={STEP_SIZE}+-{JITTER * 100:.0f}%, "
        f"{N_COLLECT} draws",
        "elapsed_s": elapsed,
        "first_call_s": first_call_s,
        "sampler_steps_per_sec": steps_per_sec,
        "draws_per_sec": steps_per_sec * N_CHAINS,
        "grad_evals_per_sec": grad_evals_per_sec,
        "ess_mean": ess_mean,
        "ess_min": ess_min,
        "ess_min_per_sec": ess_min / elapsed,
        "rhat_mean": rhat_mean,
        "rank_rhat_max": rank_rhat_max,
        "x0_mean": x0_mean,
        "x0_var": x0_var,
        "quality_gate": "passed",
    }


def bench_nuts() -> dict:
    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    init = init_with_seed(NUTS_CHAINS, 2, seed=7)
    nuts = NUTS(target, init, 0.8).seed(7)

    # First call: epsilon search + dual-averaging adaptation (and the one
    # compile). Second call re-uses the compiled program at the
    # adapted step size — that is the steady-state measurement.
    jax.block_until_ready(nuts.run(NUTS_COLLECT, NUTS_DISCARD))
    # Cumulative count over the whole first run: epsilon search + the
    # dual-averaging transient PLUS that run's collection phase (the two
    # are not separable from outside the scan) — hence "first_run", not
    # "warmup". The steady-state gate below is the per-run delta of the
    # second run, which is the number a kernel regression would move.
    divergences_first_run = int(jnp.sum(nuts.divergences))
    sample, elapsed = _timed_best(
        lambda: nuts.run(NUTS_COLLECT, NUTS_DISCARD))
    divergences_steady = int(jnp.sum(nuts.last_run_divergences))

    rhat, ess = split_rhat_mean_ess(sample)
    ess_mean = float(jnp.mean(ess))
    ess_min = float(jnp.min(ess))
    rhat_mean = float(jnp.mean(rhat))
    mean = jnp.mean(sample, axis=(0, 1))
    var = jnp.var(sample, axis=(0, 1))

    total_draws = NUTS_CHAINS * NUTS_COLLECT
    _gate("nuts rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("nuts ess floor", ess_min >= 0.005 * total_draws,
          (ess_min, total_draws))
    for d in range(2):
        _gate(f"nuts mean[{d}]",
              abs(float(mean[d]) - NUTS_MEAN[d]) <= 0.08, float(mean[d]))
        _gate(f"nuts var[{d}]",
              abs(float(var[d]) - NUTS_VAR[d]) <= 0.4, float(var[d]))
    # Steady-state divergences must be ~0 on this easy target (the
    # cumulative count is dominated by the expected
    # pre-adaptation transient; a kernel change that starts diverging in
    # steady state must fail here, not hide inside that number). Budget:
    # 1 per 10,000 chains.
    _gate("nuts steady-state divergences",
          divergences_steady <= NUTS_CHAINS // 10000,
          (divergences_steady, divergences_first_run))

    n_steps = NUTS_COLLECT + NUTS_DISCARD - 1
    out = {
        "ess_per_sec": ess_mean / elapsed,
        "config": f"Gaussian2D([0,1],[[4,2],[2,3]]) NUTS, {NUTS_CHAINS} "
        f"chains, {NUTS_COLLECT}+{NUTS_DISCARD} draws, steady state",
        "elapsed_s": elapsed,
        "sampler_steps_per_sec": n_steps / elapsed,
        "draws_per_sec": n_steps / elapsed * NUTS_CHAINS,
        "ess_mean": ess_mean,
        "ess_min": ess_min,
        "rhat_mean": rhat_mean,
        "divergences_first_run": divergences_first_run,
        "divergences_steady": divergences_steady,
        "quality_gate": "passed",
    }

    # Metric adaptation (beyond-reference, models/precondition.py): whiten
    # from the equilibrated chain ensemble and continue — the whitened 2D
    # Gaussian samples super-efficiently (ESS/draw > 1, antithetic NUTS
    # trajectories).
    tuned = nuts.reconditioned("dense", seed=11)
    # adapt + compile
    jax.block_until_ready(tuned.run(NUTS_COLLECT, NUTS_DISCARD))
    sample, elapsed = _timed_best(
        lambda: tuned.run(NUTS_COLLECT, NUTS_DISCARD))
    rhat, ess = split_rhat_mean_ess(sample)
    ess_mean = float(jnp.mean(ess))
    ess_min = float(jnp.min(ess))
    rhat_mean = float(jnp.mean(rhat))
    mean = jnp.mean(sample, axis=(0, 1))
    var = jnp.var(sample, axis=(0, 1))
    _gate("nuts-metric rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("nuts-metric ess floor", ess_min >= 0.01 * total_draws,
          (ess_min, total_draws))
    for d in range(2):
        _gate(f"nuts-metric mean[{d}]",
              abs(float(mean[d]) - NUTS_MEAN[d]) <= 0.08, float(mean[d]))
        _gate(f"nuts-metric var[{d}]",
              abs(float(var[d]) - NUTS_VAR[d]) <= 0.4, float(var[d]))
    out["preconditioned"] = {
        "ess_per_sec": ess_mean / elapsed,
        "config": "same target, dense metric from the chain ensemble "
        "(reconditioned)",
        "elapsed_s": elapsed,
        "ess_mean": ess_mean,
        "ess_min": ess_min,
        "rhat_mean": rhat_mean,
        "quality_gate": "passed",
    }
    return out


def bench_mh_gauss2d() -> dict:
    """The minimal_mh.rs config (std-normal 2D target, isotropic sigma=1
    proposal) scaled to the flagship 65,536 chains."""
    from mini_mcmc_tpu import MetropolisHastings, init_with_seed
    from mini_mcmc_tpu.models import gaussian2d, isotropic_gaussian_proposal

    c, n = 65536, 2048
    mh = MetropolisHastings(
        gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
        isotropic_gaussian_proposal(1.0),
        init_with_seed(c, 2, seed=8),
    ).seed(8)
    jax.block_until_ready(mh.run(n, 0, time_major=True))  # burn + compile
    sample, elapsed = _timed_best(
        lambda: mh.run(n, 0, time_major=True))
    rhat, ess = split_rhat_mean_ess(sample, time_major=True)
    ess_mean = float(jnp.mean(ess))
    rhat_mean = float(jnp.mean(rhat))
    mean = jnp.mean(sample, axis=(0, 1))
    var = jnp.var(sample, axis=(0, 1))
    _gate("mh2d rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    for d in range(2):
        _gate(f"mh2d mean[{d}]", abs(float(mean[d])) <= 0.03, float(mean[d]))
        _gate(f"mh2d var[{d}]", abs(float(var[d]) - 1.0) <= 0.05,
              float(var[d]))
    _gate("mh2d ess floor", ess_mean >= 0.02 * c * n, (ess_mean, c * n))
    return {
        "config": f"Gaussian2D std-normal MH, {c} chains, {n}+{n} draws",
        "elapsed_s": elapsed,
        "draws_per_sec": c * n / elapsed,
        "ess_per_sec": ess_mean / elapsed,
        "ess_mean": ess_mean,
        "rhat_mean": rhat_mean,
        "quality_gate": "passed",
    }


def bench_gibbs() -> dict:
    """The mixture_gibbs.rs config (2-component Gaussian mixture over
    [x, z], gibbs.rs:341-418 parameter set) at flagship scale: 65,536
    chains, K=32 sweeps per block."""
    from mini_mcmc_tpu import GibbsSampler
    from mini_mcmc_tpu.models import gaussian_mixture_conditional

    mu0, sigma0, mu1, sigma1, pi0 = -2.0, 1.0, 3.0, 1.5, 0.5
    c, n = 65536, 8192
    g = GibbsSampler(
        gaussian_mixture_conditional(mu0, sigma0, mu1, sigma1, pi0),
        jnp.zeros((c, 2)), steps_per_call=32,
    ).seed(42)
    jax.block_until_ready(g.run(n, 0, time_major=True))  # burn + compile
    sample, elapsed = _timed_best(
        lambda: g.run(n, 0, time_major=True))

    x = sample[:, :, 0]
    x_mean, x_var = float(jnp.mean(x)), float(jnp.var(x))
    z_mean = float(jnp.mean(sample[:, :, 1]))
    true_mean = pi0 * mu0 + (1 - pi0) * mu1
    true_var = (pi0 * (sigma0**2 + (mu0 - true_mean) ** 2)
                + (1 - pi0) * (sigma1**2 + (mu1 - true_mean) ** 2))
    rhat, _ = split_rhat_mean_ess(sample, time_major=True)
    rhat_mean = float(jnp.mean(rhat))
    _gate("gibbs x mean", abs(x_mean - true_mean) <= 0.05, x_mean)
    _gate("gibbs x var", abs(x_var - true_var) <= 0.25, x_var)
    _gate("gibbs z freq", abs(z_mean - (1 - pi0)) <= 0.02, z_mean)
    _gate("gibbs rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    return {
        "config": f"2-component mixture Gibbs, {c} chains, {n}+{n} sweeps"
        ", XLA K=32",
        "elapsed_s": elapsed,
        "draws_per_sec": c * n / elapsed,
        "x_mean": x_mean,
        "x_var": x_var,
        "z_freq": z_mean,
        "rhat_mean": rhat_mean,
        "quality_gate": "passed",
    }


def bench_extras() -> dict:
    """The Poisson-65k and d=10,000 configs (part of the default run)."""
    import numpy as np
    from scipy.stats import poisson as scipy_poisson

    from mini_mcmc_tpu import MetropolisHastings, init_det
    from mini_mcmc_tpu.models import (
        poisson_target,
        random_walk_int_proposal,
        standard_normal,
    )

    out = {}

    # 65,536-chain discrete Poisson MH (examples/poisson_mh.rs analog).
    mh = MetropolisHastings(
        poisson_target(4.0), random_walk_int_proposal(),
        jnp.zeros((65536, 1), jnp.int32),
    ).seed(42)
    jax.block_until_ready(mh.run(200, 100))
    sample, elapsed = _timed_best(lambda: mh.run(200, 100))
    ks = np.asarray(sample).ravel()
    max_err = max(
        abs(float(np.mean(ks == k)) - scipy_poisson.pmf(k, 4.0))
        for k in range(11)
    )
    _gate("poisson pmf", max_err < 0.05, max_err)
    out["poisson_mh_65k"] = {
        "config": "Poisson(4) discrete MH, 65536 chains, 200+100 draws",
        "elapsed_s": elapsed,
        # run(200, 100) takes exactly 300 sampler steps (the MH simple
        # runner's convention; runner.py) -> 300 draws per chain
        "draws_per_sec": 65536 * 300 / elapsed,
        "pmf_max_abs_err": max_err,
        "quality_gate": "passed",
    }

    # d = 10,000 HMC (hmc.rs:882-916): 6 chains, 100 collect + 100 discard.
    hmc = HMC(standard_normal(), init_det(6, 10_000), 0.1, 10).seed(0)
    jax.block_until_ready(hmc.run(100, 100))
    sample, elapsed = _timed_best(lambda: hmc.run(100, 100))
    m = float(jnp.mean(sample))
    v = float(jnp.var(sample))
    _gate("hmc10k mean", abs(m) < 0.05, m)
    _gate("hmc10k var", abs(v - 1.0) < 0.1, v)
    out["hmc_d10000"] = {
        "config": "standard normal d=10,000 HMC, 6 chains, 100+100 steps",
        "elapsed_s": elapsed,
        "steps_per_sec": 200 / elapsed,
        "grad_evals_per_sec": 200 * 6 * 10 / elapsed,
        "mean": m,
        "var": v,
        "quality_gate": "passed",
    }

    # Large-D stage at a real batch size: the 6-chain config above is
    # reference-parity but pure dispatch latency (~240 KB state); 1,024
    # chains x d=10,000 (41 MB state, 5.2 GB sample cube) streams the
    # pos/mom/grad state through device memory every leapfrog group (the
    # opposite regime from the launch-bound tiny-D flagship). eps,L follow
    # the d^(-1/4)/d^(1/4) scaling rule for iid targets.
    c_hd, d_hd, n_hd, l_hd, eps_hd = 1024, 10_000, 128, 10, 0.1
    hmc = HMC(standard_normal(), init_with_seed(c_hd, d_hd, seed=2),
              eps_hd, l_hd).seed(2)
    # burn + the one compile
    jax.block_until_ready(hmc.run(n_hd, n_hd, time_major=True))
    sample, elapsed = _timed_best(
        lambda: hmc.run(n_hd, n_hd, time_major=True))
    # Diagnostics on a contiguous 1,024-parameter slice: the FFT autocov
    # pads draws to a pow2 and batches over params, so the FULL cube's
    # diagnostics program materializes a [2C, pad, D] complex array —
    # ~21 GB at D=10,000. Coordinates are iid here, so a contiguous slice
    # (never a strided gather, which needs a cube-scale temporary) is an
    # unbiased gate; the moment gates below still cover every coordinate.
    from jax import lax as _lax

    d_diag = 1024
    sub = _lax.slice(sample, (0, 0, 0), (n_hd, c_hd, d_diag))
    rhat, ess = split_rhat_mean_ess(sub, time_major=True)
    ess_mean = float(jnp.mean(ess))
    rhat_mean = float(jnp.mean(rhat))
    m = float(jnp.mean(sample))
    v = float(jnp.var(sample))
    _gate("hmc10k-1024c mean", abs(m) < 0.02, m)
    _gate("hmc10k-1024c var", abs(v - 1.0) < 0.05, v)
    _gate("hmc10k-1024c rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("hmc10k-1024c ess floor", ess_mean >= 0.02 * c_hd * n_hd,
          (ess_mean, c_hd * n_hd))
    steps = 2 * n_hd  # run(n, n) = 2n sampler steps
    out["hmc_d10000_1024c"] = {
        "config": f"standard normal d={d_hd} HMC, {c_hd} chains, "
        f"eps={eps_hd} L={l_hd}, {n_hd}+{n_hd} draws, time-major",
        "elapsed_s": elapsed,
        "steps_per_sec": steps / elapsed,
        "draws_per_sec": steps * c_hd / elapsed,
        "coordinate_updates_per_sec": steps * c_hd * d_hd / elapsed,
        "grad_evals_per_sec": steps * c_hd * l_hd / elapsed,
        "ess_mean": ess_mean,
        "rhat_mean": rhat_mean,
        "mean": m,
        "var": v,
        "quality_gate": "passed",
    }

    return out


def bench_beyond(out: dict | None = None) -> dict:
    """The beyond-reference samplers (no reference counterpart), quality-
    gated like every other config so their README numbers are backed by
    the bench artifact instead of hand-recorded: the affine-invariant
    ensemble sampler on a correlated
    Gaussian, replica-exchange tempering recovering the mode weights of a
    32-sigma-separated bimodal mixture from a single-mode start, the
    coordinate slice sampler on the ensemble's target, elliptical slice
    on a 64-point latent-GP posterior gated against the ANALYTIC
    conjugate posterior, and the AIS/SMC evidence estimators gated
    against analytic log Z.

    ``out`` (optional) is filled stage by stage, so the caller keeps the
    stages that PASSED when a later stage's gate raises — main() records
    the failure in the artifact instead of losing the whole run."""
    import numpy as np

    from mini_mcmc_tpu import (
        EllipticalSliceSampler,
        EnsembleSampler,
        ParallelTempering,
        SliceSampler,
        geometric_betas,
    )
    from mini_mcmc_tpu.models import Target, gaussian2d

    out = {} if out is None else out

    # MALA at a dual-averaged step size (ops/adapt.py): the tuned()
    # workflow at flagship chain count on the NUTS band target. Gates:
    # moments, R-hat, ESS floor, and the tuner landing at a sane step size.
    from mini_mcmc_tpu import MALA

    cm, nm = 65536, 2048
    mala_target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    ml = MALA(
        mala_target, init_with_seed(cm, 2, seed=13), step_size=1.0,
        steps_per_call=16,
    ).seed(13).tuned(256)
    eps_tuned = float(ml.step_size)
    jax.block_until_ready(ml.run(nm, 0, time_major=True))  # burn + compile
    sample, elapsed = _timed_best(
        lambda: ml.run(nm, 0, time_major=True))
    rhat, ess = split_rhat_mean_ess(sample, time_major=True)
    ess_mean = float(jnp.mean(ess))
    rhat_mean = float(jnp.mean(rhat))
    mean = jnp.mean(sample, axis=(0, 1))
    var = jnp.var(sample, axis=(0, 1))
    _gate("mala tuned eps sane", 0.2 <= eps_tuned <= 5.0, eps_tuned)
    _gate("mala rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("mala ess floor", ess_mean >= 0.005 * cm * nm,
          (ess_mean, cm * nm))
    for d, (m_true, v_true) in enumerate(((0.0, 4.0), (1.0, 3.0))):
        _gate(f"mala mean[{d}]",
              abs(float(mean[d]) - m_true) <= 0.05, float(mean[d]))
        _gate(f"mala var[{d}]",
              abs(float(var[d]) - v_true) <= 0.3, float(var[d]))
    out["mala_tuned_65k"] = {
        "config": f"Gaussian2D([0,1],[[4,2],[2,3]]) MALA, {cm} chains, "
        f"{nm}+{nm} draws, dual-averaged eps (256 adapt steps), XLA K=16",
        "elapsed_s": elapsed,
        "draws_per_sec": cm * nm / elapsed,
        "ess_per_sec": ess_mean / elapsed,
        "ess_mean": ess_mean,
        "eps_tuned": eps_tuned,
        "rhat_mean": rhat_mean,
        "quality_gate": "passed",
    }

    # ChEES-HMC: jointly adapted (step size, trajectory length) from the
    # cross-chain criterion (ops/chees.py), then jittered-trajectory
    # production sampling — the lockstep NUTS alternative, on the NUTS
    # band target. Gates: the trajectory actually grew, moments, R-hat,
    # and an ESS floor far above the one-leapfrog samplers'.
    from mini_mcmc_tpu import ChEESHMC

    cc, nc = 65536, 2048
    ch = ChEESHMC(
        mala_target, init_with_seed(cc, 2, seed=17), step_size=0.5,
    ).seed(17).warmed_up(256)
    jax.block_until_ready(ch.run(nc, 0, time_major=True))  # burn + compile
    sample, elapsed = _timed_best(
        lambda: ch.run(nc, 0, time_major=True))
    rhat, ess = split_rhat_mean_ess(sample, time_major=True)
    ess_mean = float(jnp.mean(ess))
    ess_min = float(jnp.min(ess))
    rhat_mean = float(jnp.mean(rhat))
    mean = jnp.mean(sample, axis=(0, 1))
    var = jnp.var(sample, axis=(0, 1))
    _gate("chees traj grew", ch.traj_len > 2.0 * ch.step_size,
          (ch.traj_len, ch.step_size))
    _gate("chees rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("chees ess floor", ess_min >= 0.02 * cc * nc,
          (ess_min, cc * nc))
    for d, (m_true, v_true) in enumerate(((0.0, 4.0), (1.0, 3.0))):
        _gate(f"chees mean[{d}]",
              abs(float(mean[d]) - m_true) <= 0.05, float(mean[d]))
        _gate(f"chees var[{d}]",
              abs(float(var[d]) - v_true) <= 0.3, float(var[d]))
    out["chees_65k"] = {
        "config": f"Gaussian2D([0,1],[[4,2],[2,3]]) ChEES-HMC, {cc} "
        f"chains, {nc}+{nc} draws, jointly adapted eps+T (256 steps), "
        "jittered dynamic trajectories, XLA",
        "elapsed_s": elapsed,
        "draws_per_sec": cc * nc / elapsed,
        "ess_per_sec": ess_mean / elapsed,
        "ess_min_per_sec": ess_min / elapsed,
        "ess_mean": ess_mean,
        "eps_tuned": float(ch.step_size),
        "traj_len_tuned": float(ch.traj_len),
        "rhat_mean": rhat_mean,
        "quality_gate": "passed",
    }

    # Ensemble: 1,024 independent ensembles x 64 walkers in one batch.
    c, n, w = 65536, 2048, 64
    target = gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    es = EnsembleSampler(
        target, init_with_seed(c, 2, seed=3), walkers_per_ensemble=w,
        steps_per_call=16,
    ).seed(3)
    jax.block_until_ready(es.run(n, 0, time_major=True))  # burn + compile
    sample, elapsed = _timed_best(
        lambda: es.run(n, 0, time_major=True))
    rhat, ess = split_rhat_mean_ess(sample, time_major=True)
    ess_mean = float(jnp.mean(ess))
    rhat_mean = float(jnp.mean(rhat))
    mean = jnp.mean(sample, axis=(0, 1))
    var = jnp.var(sample, axis=(0, 1))
    cov01 = float(jnp.mean(
        (sample[:, :, 0] - mean[0]) * (sample[:, :, 1] - mean[1])
    ))
    _gate("ensemble rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("ensemble ess floor", ess_mean >= 1e-3 * c * n, (ess_mean, c * n))
    for d, (m_true, v_true) in enumerate(((0.0, 4.0), (1.0, 3.0))):
        _gate(f"ensemble mean[{d}]",
              abs(float(mean[d]) - m_true) <= 0.05, float(mean[d]))
        _gate(f"ensemble var[{d}]",
              abs(float(var[d]) - v_true) <= 0.2, float(var[d]))
    _gate("ensemble cov01", abs(cov01 - 2.0) <= 0.2, cov01)
    out["ensemble_65k"] = {
        "config": f"Gaussian2D([0,1],[[4,2],[2,3]]) stretch move, {c} "
        f"walkers (1024 ensembles x {w}), {n}+{n} sweeps, XLA K=16",
        "elapsed_s": elapsed,
        "draws_per_sec": c * n / elapsed,
        "ess_per_sec": ess_mean / elapsed,
        "rhat_mean": rhat_mean,
        "quality_gate": "passed",
    }

    # Tempering: 0.3*N(-8, 0.5^2) + 0.7*N(+8, 0.5^2), ALL chains started
    # in the 30% mode — the config single-temperature MH provably cannot
    # sample (tests/test_tempering.py's negative control).
    w_plus = 0.7

    def _logp(x):
        a = jnp.log(1 - w_plus) - 0.5 * ((x[0] + 8.0) / 0.5) ** 2
        b = jnp.log(w_plus) - 0.5 * ((x[0] - 8.0) / 0.5) ** 2
        return jnp.logaddexp(a, b)

    def _logp_batch(xs):
        a = jnp.log(1 - w_plus) - 0.5 * ((xs[:, 0] + 8.0) / 0.5) ** 2
        b = jnp.log(w_plus) - 0.5 * ((xs[:, 0] - 8.0) / 0.5) ** 2
        return jnp.logaddexp(a, b)

    def _logp_dc(pos_dc):  # chains-on-lanes [D, C] -> [C] fast path
        a = jnp.log(1 - w_plus) - 0.5 * ((pos_dc[0] + 8.0) / 0.5) ** 2
        b = jnp.log(w_plus) - 0.5 * ((pos_dc[0] - 8.0) / 0.5) ** 2
        return jnp.logaddexp(a, b)

    ct, nt, n_temps = 8192, 2048, 8
    pt = ParallelTempering(
        Target(logp=_logp, logp_batch=_logp_batch, logp_dc=_logp_dc),
        jnp.full((ct, 1), -8.0), betas=geometric_betas(n_temps, 0.01),
        proposal_std=1.0, steps_per_call=16,
    ).seed(5)
    jax.block_until_ready(pt.run(nt, 0, time_major=True))  # burn + compile
    sample, elapsed = _timed_best(
        lambda: pt.run(nt, 0, time_major=True))
    xs = np.asarray(sample).ravel()
    frac_plus = float(np.mean(xs > 0))
    plus = xs[xs > 0]
    _gate("tempering mode weight", abs(frac_plus - w_plus) <= 0.05,
          frac_plus)
    _gate("tempering mode mean", abs(float(plus.mean()) - 8.0) <= 0.05,
          float(plus.mean()))
    _gate("tempering mode std", abs(float(plus.std()) - 0.5) <= 0.05,
          float(plus.std()))
    swap = np.asarray(pt.swap_acceptance)
    _gate("tempering swap rates alive", bool(np.all(swap > 0.05)),
          swap.tolist())
    out["tempering_bimodal_8k"] = {
        "config": f"0.3/0.7 bimodal mixture (32-sigma gap), {ct} chains x "
        f"{n_temps} temperatures, {nt}+{nt} steps, single-mode start, "
        "XLA K=16",
        "elapsed_s": elapsed,
        "cold_draws_per_sec": ct * nt / elapsed,
        "replica_updates_per_sec": ct * n_temps * nt / elapsed,
        "mode_weight": frac_plus,
        "min_swap_acceptance": float(swap.min()),
        "quality_gate": "passed",
    }

    # Coordinate slice sampling (ops/slice.py) on the ensemble stage's
    # correlated Gaussian: gradient-free AND tuning-free — width=1 on a
    # std-2 target just steps out. Same moment/R-hat gates.
    cs, ns = 65536, 2048
    sl = SliceSampler(
        target, init_with_seed(cs, 2, seed=7), width=1.0,
        steps_per_call=16,
    ).seed(7)
    jax.block_until_ready(sl.run(ns, 0, time_major=True))  # burn + compile
    sample, elapsed = _timed_best(
        lambda: sl.run(ns, 0, time_major=True))
    rhat, ess = split_rhat_mean_ess(sample, time_major=True)
    ess_mean = float(jnp.mean(ess))
    rhat_mean = float(jnp.mean(rhat))
    mean = jnp.mean(sample, axis=(0, 1))
    var = jnp.var(sample, axis=(0, 1))
    _gate("slice rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("slice ess floor", ess_mean >= 0.05 * cs * ns, (ess_mean, cs * ns))
    for d, (m_true, v_true) in enumerate(((0.0, 4.0), (1.0, 3.0))):
        _gate(f"slice mean[{d}]",
              abs(float(mean[d]) - m_true) <= 0.05, float(mean[d]))
        _gate(f"slice var[{d}]",
              abs(float(var[d]) - v_true) <= 0.2, float(var[d]))
    out["slice_gauss2d_65k"] = {
        "config": f"Gaussian2D([0,1],[[4,2],[2,3]]) coordinate slice, "
        f"{cs} chains, {ns}+{ns} sweeps, width=1, XLA K=16",
        "elapsed_s": elapsed,
        "sweeps_per_sec": cs * ns / elapsed,
        "ess_per_sec": ess_mean / elapsed,
        "rhat_mean": rhat_mean,
        "quality_gate": "passed",
    }

    # Elliptical slice (ops/elliptical.py) on a 64-point latent-GP
    # posterior with a CONJUGATE Gaussian likelihood, so the gate is the
    # analytic posterior: mean = K(K+s^2 I)^-1 y, cov = K - K(K+s^2 I)^-1 K
    # (computed in float64 from the exact float32 Cholesky the sampler
    # uses). The prior draw is a [C, 64] @ [64, 64] matmul per step.
    d_gp, c_el, n_el, s_noise = 64, 4096, 2048, 0.3
    xs_gp = np.linspace(-3.0, 3.0, d_gp)
    k_gp = np.exp(-0.5 * (xs_gp[:, None] - xs_gp[None, :]) ** 2 / 0.6**2)
    chol64 = np.linalg.cholesky(k_gp + 1e-4 * np.eye(d_gp))
    chol32 = jnp.asarray(chol64, jnp.float32)
    k_eff = np.asarray(chol32, np.float64) @ np.asarray(chol32, np.float64).T
    rng = np.random.default_rng(0)
    f_true = chol64 @ rng.standard_normal(d_gp)
    y64 = f_true + s_noise * rng.standard_normal(d_gp)
    solve = np.linalg.solve(k_eff + s_noise**2 * np.eye(d_gp), y64)
    post_mean = k_eff @ solve
    post_cov = k_eff - k_eff @ np.linalg.solve(
        k_eff + s_noise**2 * np.eye(d_gp), k_eff
    )
    y32 = jnp.asarray(y64, jnp.float32)

    def _gp_loglik_batch(f):
        return -0.5 * jnp.sum(((y32 - f) / s_noise) ** 2, axis=-1)

    el = EllipticalSliceSampler(
        Target(logp=lambda f: _gp_loglik_batch(f[None])[0],
               logp_batch=_gp_loglik_batch),
        jnp.zeros((c_el, d_gp), jnp.float32), prior_scale=chol32,
        steps_per_call=16,
    ).seed(9)
    jax.block_until_ready(el.run(n_el, 0, time_major=True))  # burn + compile
    sample, elapsed = _timed_best(
        lambda: el.run(n_el, 0, time_major=True))
    rhat, _ = split_rhat_mean_ess(sample, time_major=True)
    rhat_mean = float(jnp.mean(rhat))
    mean = np.asarray(jnp.mean(sample, axis=(0, 1)), np.float64)
    var = np.asarray(jnp.var(sample, axis=(0, 1)), np.float64)
    mean_err = float(np.max(np.abs(mean - post_mean)))
    var_err = float(np.max(np.abs(var / np.diag(post_cov) - 1.0)))
    # The (reference-quirk) inverted split R-hat sqrt(W/var) approaches 1
    # FROM BELOW as n grows on an autocorrelated chain; the slowest GP
    # coordinates sit near 0.95 at n=2048, so the band is wider here —
    # the analytic posterior-moment gates below are the sharp check.
    _gate("elliptical rhat", 0.90 <= rhat_mean <= 1.05, rhat_mean)
    _gate("elliptical posterior mean", mean_err <= 0.05, mean_err)
    _gate("elliptical posterior var", var_err <= 0.2, var_err)
    out["elliptical_gp64_4k"] = {
        "config": f"latent GP, {d_gp} points, conjugate Gaussian "
        f"likelihood, {c_el} chains, {n_el}+{n_el} steps, XLA K=16, "
        "vs analytic posterior",
        "elapsed_s": elapsed,
        "latent_draws_per_sec": c_el * n_el / elapsed,
        "latent_values_per_sec": c_el * n_el * d_gp / elapsed,
        "max_abs_mean_err": mean_err,
        "max_rel_var_err": var_err,
        "rhat_mean": rhat_mean,
        "quality_gate": "passed",
    }

    # Annealed importance sampling (ops/ais.py): log-Z of an unnormalized
    # correlated Gaussian, gated against the ANALYTIC normalizer — a wrong
    # weight accumulation cannot hide (E[w] = Z exactly).
    from mini_mcmc_tpu.ops.ais import ais_log_z, make_anneal

    cov = jnp.asarray([[4.0, 2.0], [2.0, 3.0]], jnp.float32)
    prec = jnp.linalg.inv(cov)
    true_log_z = float(
        0.5 * (2 * np.log(2 * np.pi) + np.linalg.slogdet(np.asarray(cov))[1])
    )

    def _ais_logp_batch(xs):
        return -0.5 * jnp.einsum("ni,ij,nj->n", xs, prec, xs)

    ais_target = Target(logp=lambda x: _ais_logp_batch(x[None])[0],
                        logp_batch=_ais_logp_batch)
    n_part, n_rungs, n_mh = 65536, 64, 2
    kw = dict(betas=n_rungs, n_mh_steps=n_mh, proposal_std=1.0,
              prior_std=2.5)
    r = ais_log_z(ais_target, n_part, 2, seed=0, **kw)  # compile + check
    anneal = make_anneal(ais_target, tuple(
        float(b) for b in np.linspace(0.0, 1.0, n_rungs + 1)[1:]), **{
            k: v for k, v in kw.items() if k != "betas"})
    x0 = 2.5 * jax.random.normal(jax.random.PRNGKey(2), (n_part, 2),
                                 jnp.float32)
    rkeys = jax.random.split(jax.random.PRNGKey(3), n_rungs)
    jax.block_until_ready(anneal(x0, rkeys)[0])  # compile the timed signature
    (_, elapsed) = _timed_best(lambda: anneal(x0, rkeys)[0])
    _gate("ais log_z", abs(float(r.log_z) - true_log_z) < 0.05,
          (float(r.log_z), true_log_z))
    _gate("ais weight ess", float(r.weight_ess) > 0.3,
          float(r.weight_ess))
    out["ais_evidence_65k"] = {
        "config": f"unnormalized correlated Gaussian2D, {n_part} "
        f"particles, {n_rungs} rungs x {n_mh} MH steps, vs analytic log Z",
        "elapsed_s": elapsed,
        "particle_updates_per_sec": n_part * n_rungs * (1 + n_mh) / elapsed,
        "log_z": float(r.log_z),
        "log_z_true": true_log_z,
        "weight_ess": float(r.weight_ess),
        "quality_gate": "passed",
    }

    # Adaptive SMC (ops/smc.py) on the same target: schedule chosen by
    # in-graph ESS bisection, same analytic gate. The jitted program is
    # built ONCE via make_smc_run (a fresh smc_log_z call re-traces), so
    # the steady number times execution, not compilation.
    from mini_mcmc_tpu.ops.smc import make_smc_run

    smc_run = make_smc_run(ais_target, proposal_std=1.0, prior_std=2.5)
    x0s = 2.5 * jax.random.normal(jax.random.PRNGKey(4), (n_part, 2),
                                  jnp.float32)
    t0 = time.monotonic()
    out_s = jax.block_until_ready(smc_run(x0s, jax.random.PRNGKey(5)))
    smc_first = time.monotonic() - t0  # includes compile
    t0 = time.monotonic()
    out_s = jax.block_until_ready(smc_run(x0s, jax.random.PRNGKey(6)))
    smc_elapsed = time.monotonic() - t0
    _, beta_s, log_z_s, j_s, _, _ = out_s
    smc_log_z_v, smc_stages = float(log_z_s), int(j_s)
    _gate("smc completed", float(beta_s) == 1.0, float(beta_s))
    _gate("smc log_z", abs(smc_log_z_v - true_log_z) < 0.05,
          (smc_log_z_v, true_log_z))
    out["smc_evidence_65k"] = {
        "config": f"same target, {n_part} particles, adaptive schedule "
        "(target_ess=0.8, 5 MH sweeps/stage), vs analytic log Z",
        "elapsed_s": smc_elapsed,
        "first_call_s": smc_first,
        "n_stages": smc_stages,
        "log_z": smc_log_z_v,
        "log_z_true": true_log_z,
        "quality_gate": "passed",
    }

    # Minibatch SGLD (ops/sgmcmc.py) on a CONJUGATE Bayesian linear
    # regression over 65,536 device-resident rows — the analytic
    # posterior N((X'X/s^2 + I/tau^2)^-1 X'y/s^2, .) is the gate, so both
    # estimator bias (a wrong N/B scale) and discretization bias (a step
    # size that stopped decaying) fail loudly. Each step touches B=1024
    # rows: one [B, D] @ [D, C] matmul for all chains.
    from mini_mcmc_tpu import SGLD, minibatch_grad, polynomial_decay

    n_rows, d_lr, b_mb, c_lr, n_lr = 65536, 8, 1024, 4096, 2048
    s_noise_lr, tau_lr = 0.5, 2.0
    rng_lr = np.random.default_rng(0)
    x_lr = rng_lr.standard_normal((n_rows, d_lr)).astype(np.float32)
    x_lr /= np.sqrt(d_lr)
    w_true = np.linspace(-1.0, 1.0, d_lr).astype(np.float32)
    y_lr = (x_lr @ w_true
            + s_noise_lr * rng_lr.standard_normal(n_rows)).astype(np.float32)
    x64, y64_lr = x_lr.astype(np.float64), y_lr.astype(np.float64)
    prec_lr = x64.T @ x64 / s_noise_lr**2 + np.eye(d_lr) / tau_lr**2
    post_cov_lr = np.linalg.inv(prec_lr)
    post_mean_lr = post_cov_lr @ (x64.T @ y64_lr) / s_noise_lr**2
    post_sd_lr = np.sqrt(np.diag(post_cov_lr))

    grad_fn = minibatch_grad(
        lambda w: -0.5 * jnp.sum(w * w) / tau_lr**2,
        lambda w, batch: -0.5 * jnp.sum(
            (batch[1] - batch[0] @ w) ** 2) / s_noise_lr**2,
        (jnp.asarray(x_lr), jnp.asarray(y_lr)), batch_size=b_mb,
    )
    sg = SGLD(
        grad_fn, init_with_seed(c_lr, d_lr, seed=21),
        step_size=polynomial_decay(2e-6, 50.0, 0.33),
        seed=21, steps_per_call=16,
    )
    jax.block_until_ready(sg.run(n_lr, n_lr, time_major=True))  # burn into the
    # posterior-typical set + compile; the timed run continues the chains
    sample, elapsed = _timed_best(
        lambda: sg.run(n_lr, 0, time_major=True))
    mean = np.asarray(jnp.mean(sample, axis=(0, 1)), np.float64)
    var = np.asarray(jnp.var(sample, axis=(0, 1)), np.float64)
    mean_err_sd = float(np.max(np.abs(mean - post_mean_lr) / post_sd_lr))
    var_rel = float(np.max(np.abs(var / np.diag(post_cov_lr) - 1.0)))
    _gate("sgld posterior mean", mean_err_sd <= 1.0, mean_err_sd)
    _gate("sgld posterior var", var_rel <= 0.3, var_rel)
    out["sgld_minibatch_65k_rows"] = {
        "config": f"conjugate Bayesian linear regression, N={n_rows} "
        f"rows, D={d_lr}, minibatch B={b_mb} "
        f"({100.0 * b_mb / n_rows:.1f}% per step), {c_lr} chains, "
        f"{n_lr}+{n_lr} steps, decaying eps, XLA K=16, "
        "vs analytic posterior",
        "elapsed_s": elapsed,
        "draws_per_sec": c_lr * n_lr / elapsed,
        "minibatch_rows_per_sec": b_mb * n_lr / elapsed,
        "max_mean_err_posterior_sd": mean_err_sd,
        "max_rel_var_err": var_rel,
        "quality_gate": "passed",
    }

    # Data-parallel SGLD (ops/sgmcmc.py data_parallel_grad): the SAME
    # conjugate regression, but the rows sharded over a "data" device
    # mesh and the partial gradients reduced with exactly ONE psum per
    # step. On a one-card host the mesh is 1-wide and the psum is the
    # identity — this stage certifies the sharded CODE PATH (shard_map +
    # per-shard RNG fold + local gather) on the device against the
    # analytic posterior (`chip_smoke.py --multi` runs the psum over four
    # cards); the 8-way unbiasedness,
    # collective-count, and end-to-end posterior proofs run on the
    # virtual CPU mesh every suite run (tests/test_parallel.py).
    from mini_mcmc_tpu import data_parallel_grad
    from mini_mcmc_tpu.parallel import data_mesh

    dp_mesh = data_mesh()
    dp_grad = data_parallel_grad(
        lambda w: -0.5 * jnp.sum(w * w) / tau_lr**2,
        lambda w, batch: -0.5 * jnp.sum(
            (batch[1] - batch[0] @ w) ** 2) / s_noise_lr**2,
        (jnp.asarray(x_lr), jnp.asarray(y_lr)), batch_size=b_mb,
        mesh=dp_mesh,
    )
    sg_dp = SGLD(
        dp_grad, init_with_seed(c_lr, d_lr, seed=23),
        step_size=polynomial_decay(2e-6, 50.0, 0.33),
        seed=23, steps_per_call=16,
    )
    jax.block_until_ready(sg_dp.run(n_lr, n_lr, time_major=True))
    sample, elapsed = _timed_best(
        lambda: sg_dp.run(n_lr, 0, time_major=True))
    mean = np.asarray(jnp.mean(sample, axis=(0, 1)), np.float64)
    var = np.asarray(jnp.var(sample, axis=(0, 1)), np.float64)
    mean_err_sd = float(np.max(np.abs(mean - post_mean_lr) / post_sd_lr))
    var_rel = float(np.max(np.abs(var / np.diag(post_cov_lr) - 1.0)))
    _gate("dp-sgld posterior mean", mean_err_sd <= 1.0, mean_err_sd)
    _gate("dp-sgld posterior var", var_rel <= 0.3, var_rel)
    out["sgld_data_parallel_65k_rows"] = {
        "config": f"same regression via data_parallel_grad over a "
        f"{dp_mesh.devices.size}-device 'data' mesh (one card: psum is "
        "identity; 8-way mesh proofs in tests/test_parallel.py), one "
        "all-reduce per step",
        "n_devices": int(dp_mesh.devices.size),
        "elapsed_s": elapsed,
        "draws_per_sec": c_lr * n_lr / elapsed,
        "max_mean_err_posterior_sd": mean_err_sd,
        "max_rel_var_err": var_rel,
        "quality_gate": "passed",
    }

    # pSGLD (ops/sgmcmc.py, preconditioner="rmsprop") on a 100x
    # anisotropic Gaussian: ONE shared step size samples every coordinate
    # because RMSProp rescales each by ~sigma — the scale-equalization
    # story measured at bench scale. rms_decay=0.9999 (not the 0.99
    # default) decorrelates the EWMA V from the current state, shrinking
    # the dropped-Gamma-term bias (CLAUDE.md pSGLD note: SMALLER steps
    # make that bias worse, longer memory fixes it — measured 0.39 ->
    # 0.14 max rel var err going 0.999 -> 0.9999); the variance gate
    # bands include the residual bias. The equalization-ratio gate is
    # the claim itself: sampled scales track the target's 100x.
    d_ps, c_ps, n_ps = 8, 4096, 2048
    sigma2_ps = jnp.asarray(np.logspace(0.0, 2.0, d_ps), jnp.float32)

    def _aniso_grad(x, key):
        del key
        return -x / sigma2_ps[None, :]

    psgld = SGLD(
        _aniso_grad, init_with_seed(c_ps, d_ps, seed=27),
        step_size=0.02, seed=27, preconditioner="rmsprop",
        rms_decay=0.9999, steps_per_call=16,
    )
    jax.block_until_ready(psgld.run(n_ps, 2 * n_ps, time_major=True))
    sample, elapsed = _timed_best(
        lambda: psgld.run(n_ps, 0, time_major=True))
    var = np.asarray(jnp.var(sample, axis=(0, 1)), np.float64)
    sig = np.asarray(sigma2_ps, np.float64)
    rel_var = float(np.max(np.abs(var / sig - 1.0)))
    eq_ratio = float(var[-1] / var[0])
    _gate("psgld per-coordinate variance", rel_var <= 0.3, var / sig)
    _gate("psgld scale equalization", 80.0 < eq_ratio < 140.0, eq_ratio)
    out["psgld_anisotropic_100x"] = {
        "config": f"N(0, diag(1..100)) ({d_ps}D log-spaced), one shared "
        f"eps=0.02 via RMSProp preconditioning, {c_ps} chains, "
        f"{n_ps}+{2 * n_ps} steps, rms_decay=0.9999, XLA K=16",
        "elapsed_s": elapsed,
        "draws_per_sec": c_ps * n_ps / elapsed,
        "max_rel_var_err": rel_var,
        "scale_equalization_ratio": eq_ratio,
        "quality_gate": "passed",
    }

    # SGHMC (ops/sgmcmc.py) on the SAME conjugate regression as the SGLD
    # stage: friction-damped momenta absorb the minibatch gradient noise,
    # the analytic posterior is the gate. The friction must DOMINATE the
    # minibatch-noise scale (measured: eps=2e-6 const at friction=0.05
    # inflates the variance 52x; the decaying schedule + friction=0.5
    # lands at 17% — variance bias ~ eps/friction) and momenta
    # equilibrate in ~1/friction = 2 steps, far inside the discard.
    from mini_mcmc_tpu import SGHMC

    sghmc = SGHMC(
        grad_fn, init_with_seed(c_lr, d_lr, seed=29),
        step_size=polynomial_decay(1e-6, 50.0, 0.33),
        friction=0.5, seed=29, steps_per_call=16,
    )
    jax.block_until_ready(sghmc.run(n_lr, n_lr, time_major=True))
    sample, elapsed = _timed_best(
        lambda: sghmc.run(n_lr, 0, time_major=True))
    mean = np.asarray(jnp.mean(sample, axis=(0, 1)), np.float64)
    var = np.asarray(jnp.var(sample, axis=(0, 1)), np.float64)
    mean_err_sd = float(np.max(np.abs(mean - post_mean_lr) / post_sd_lr))
    var_rel = float(np.max(np.abs(var / np.diag(post_cov_lr) - 1.0)))
    _gate("sghmc posterior mean", mean_err_sd <= 1.0, mean_err_sd)
    _gate("sghmc posterior var", var_rel <= 0.4, var_rel)
    out["sghmc_minibatch_65k_rows"] = {
        "config": f"same regression, SGHMC decaying eps (1e-6 poly-0.33) "
        f"friction=0.5, B={b_mb}, {c_lr} chains, {n_lr}+{n_lr} steps, "
        "XLA K=16, vs analytic posterior",
        "elapsed_s": elapsed,
        "draws_per_sec": c_lr * n_lr / elapsed,
        "max_mean_err_posterior_sd": mean_err_sd,
        "max_rel_var_err": var_rel,
        "quality_gate": "passed",
    }
    return out


def bench_eight_schools() -> dict:
    """Hard-geometry gate: eight schools (Rubin 1981), the hierarchical
    funnel posterior, non-centered in D=10 with quadrature-EXACT posterior
    means as ground truth (examples/eight_schools_nuts.py) — evidence the
    adaptive machinery wins where geometry is hard, not only on Gaussian
    and Rosenbrock targets. NUTS.warmed_up (ensemble diag metric +
    dual-averaged eps in the whitened space) and ChEESHMC.warmed_up
    (jointly adapted step size + trajectory length) both run at bench
    scale, gated on the exact moments, R-hat, an ESS floor, and (NUTS)
    the steady-state divergence rate."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "eight_schools_nuts",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "examples", "eight_schools_nuts.py"),
    )
    es8 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(es8)
    exact_mu, exact_tau = es8.exact_posterior_means()
    out: dict = {"exact_mu": exact_mu, "exact_tau": exact_tau}

    c8, n8, nd8 = 4096, 1024, 256
    d8 = 10

    def _moment_gates(label, sample, rhat_mean, ess_min):
        mu_hat = float(jnp.mean(sample[:, :, 0]))
        tau_hat = float(jnp.mean(jnp.exp(sample[:, :, 1])))
        _gate(f"{label} E[mu]", abs(mu_hat - exact_mu) <= 0.25,
              (mu_hat, exact_mu))
        _gate(f"{label} E[tau]", abs(tau_hat - exact_tau) <= 0.4,
              (tau_hat, exact_tau))
        _gate(f"{label} rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
        _gate(f"{label} ess floor", ess_min >= 0.002 * c8 * n8,
              (ess_min, c8 * n8))
        return mu_hat, tau_hat

    # NUTS with an ensemble-estimated diag metric (warmed_up): 300
    # unwhitened adaptation steps, then eps re-adapts in the whitened
    # space during each run's discard phase. target_accept=0.9 — the
    # standard hierarchical-model setting (0.8 measures a 1.2% steady
    # divergence rate here; 0.9 measures ~1e-5 AND 6x the min ESS).
    target = es8.make_noncentered_target()
    warm = NUTS(target, init_with_seed(c8, d8, seed=31), 0.9,
                seed=31).warmed_up(300, "diag")
    # whitened eps adaptation + compile
    jax.block_until_ready(warm.run(n8, nd8))
    sample, elapsed = _timed_best(lambda: warm.run(n8, nd8))
    div_steady = int(jnp.sum(warm.last_run_divergences))
    div_rate = div_steady / (c8 * (n8 + nd8 - 1))
    rhat, ess = split_rhat_mean_ess(sample)
    ess_mean, ess_min = float(jnp.mean(ess)), float(jnp.min(ess))
    mu_hat, tau_hat = _moment_gates("8schools nuts", sample,
                                    float(jnp.mean(rhat)), ess_min)
    # non-centered + metric: the steady state must be clean (the example
    # pins the CENTERED parameterization's rate staying high as the
    # practitioner's funnel signal; the bench gates the production path)
    _gate("8schools nuts steady-state divergence rate", div_rate <= 2e-3,
          div_rate)
    # Lockstep-efficiency accounting (the masked-lane waste the lockstep
    # NUTS design accepts, ops/nuts.py:21-39): executed leapfrogs = one
    # gradient eval each, every lane pays the deepest chain's tree.
    nuts_steps = n8 + nd8 - 1
    nuts_lf_per_draw = float(warm.last_run_leapfrogs[0]) / nuts_steps
    nuts_grad_evals = c8 * (float(warm.last_run_leapfrogs[0]) + nuts_steps)
    out["nuts_diag_metric"] = {
        "config": f"non-centered 8 schools D={d8}, NUTS.warmed_up(diag), "
        f"{c8} chains, {n8}+{nd8} draws, steady state",
        "elapsed_s": elapsed,
        "ess_per_sec": ess_mean / elapsed,
        "ess_mean": ess_mean,
        "ess_min": ess_min,
        "rhat_mean": float(jnp.mean(rhat)),
        "mu_hat": mu_hat,
        "tau_hat": tau_hat,
        "steady_state_divergence_rate": div_rate,
        "leapfrogs_per_draw": nuts_lf_per_draw,
        "grad_evals_per_effective_sample": nuts_grad_evals / ess_mean,
        "quality_gate": "passed",
    }

    # ChEESHMC: same posterior, trajectory length adapted from the
    # cross-chain criterion — after warmup the kernel is fixed-cost HMC
    # with zero tree bookkeeping (the lockstep-efficiency story).
    from mini_mcmc_tpu import ChEESHMC

    ch = ChEESHMC(target, init_with_seed(c8, d8, seed=33),
                  step_size=0.2, seed=33).warmed_up(500)
    jax.block_until_ready(ch.run(n8, nd8))  # burn to steady state + compile
    sample, elapsed = _timed_best(lambda: ch.run(n8, nd8))
    rhat, ess = split_rhat_mean_ess(sample)
    ess_mean, ess_min = float(jnp.mean(ess)), float(jnp.min(ess))
    mu_hat, tau_hat = _moment_gates("8schools chees", sample,
                                    float(jnp.mean(rhat)), ess_min)
    out["chees_adapted"] = {
        "config": f"same posterior, ChEESHMC.warmed_up(500), {c8} chains, "
        f"{n8}+{nd8} draws, steady state",
        "elapsed_s": elapsed,
        "ess_per_sec": ess_mean / elapsed,
        "ess_mean": ess_mean,
        "ess_min": ess_min,
        "rhat_mean": float(jnp.mean(rhat)),
        "mu_hat": mu_hat,
        "tau_hat": tau_hat,
        "adapted_step_size": float(ch.step_size),
        "adapted_traj_len": float(ch.traj_len),
        "mean_leapfrogs_per_draw":
            float(ch.traj_len) / (2.0 * float(ch.step_size)),
        # fixed-cost kernel: L + 1 grad evals per draw per chain (vs the
        # NUTS stage's measured executed-leapfrog accounting above)
        "grad_evals_per_effective_sample":
            c8 * (n8 + nd8)
            * (float(ch.traj_len) / (2.0 * float(ch.step_size)) + 1.0)
            / ess_mean,
        "quality_gate": "passed",
    }

    out["quality_gate"] = "passed"
    return out


def _staged(name, fn, _t0=[None]):
    """Run one bench stage with a wall-clock marker on stderr (the JSON
    contract is stdout-only) — makes a slow compile attributable."""
    if _t0[0] is None:
        _t0[0] = time.monotonic()
    t = time.monotonic()
    out = fn()
    print(f"[bench {time.monotonic() - _t0[0]:7.1f}s] {name} done "
          f"(+{time.monotonic() - t:.1f}s)", file=sys.stderr, flush=True)
    return out


def main(extra: bool = False):
    del extra  # accepted for compatibility; everything runs by default
    device = jax.devices()[0]
    if device.platform != "gpu":
        # a CPU number is not a device number: refuse, do not fall back
        print(f"[bench] no GPU (JAX platform {device.platform!r}); "
              "nothing measured", file=sys.stderr, flush=True)
        sys.exit(2)
    from chip_smoke import card_line, configure_compile_cache

    cache_dir = configure_compile_cache()
    hmc = _staged("hmc_flagship", bench_hmc_flagship)
    nuts = _staged("nuts", bench_nuts)
    ess_per_sec = hmc.pop("ess_per_sec")
    detail = dict(hmc)
    detail["backend"] = jax.default_backend()
    detail["device_kind"] = device.device_kind
    detail["device_count"] = len(jax.devices())
    detail["card"] = card_line()
    detail["compile_cache_dir"] = cache_dir
    detail["nuts"] = nuts
    detail["mh_gauss2d_65k"] = _staged("mh_gauss2d", bench_mh_gauss2d)
    detail["gibbs_mixture_65k"] = _staged("gibbs", bench_gibbs)
    detail.update(_staged("extras", bench_extras))
    # Beyond-reference stages: a gate failure here is recorded in the
    # artifact (loudly, with the failed stage's gate message) instead of
    # destroying the whole run — the headline metric and every
    # reference-config stage above stay strict. The ratchet below still
    # fails the run for every floored stage that is missing.
    beyond: dict = {}
    try:
        _staged("beyond", lambda: bench_beyond(beyond))
    except Exception as e:  # noqa: BLE001 — recorded, not swallowed
        beyond["beyond_gate_failed"] = f"{type(e).__name__}: {e}"
        print(f"[bench] beyond stage FAILED: {e}", file=sys.stderr,
              flush=True)
    try:
        beyond["eight_schools_10d"] = _staged("eight_schools",
                                              bench_eight_schools)
    except Exception as e:  # noqa: BLE001 — recorded, not swallowed
        beyond["eight_schools_gate_failed"] = f"{type(e).__name__}: {e}"
        print(f"[bench] eight_schools stage FAILED: {e}", file=sys.stderr,
              flush=True)
    detail.update(beyond)
    result = {
        "metric": "effective_samples_per_sec_per_chip",
        "value": ess_per_sec,
        "unit": "ESS/s",
        "vs_baseline": ess_per_sec / BASELINE_ESS_PER_SEC,
        "detail": detail,
    }
    compact = _compact_summary(result)
    # Perf ratchet AFTER the summary walk (it annotates stage dicts with
    # their floors, so the full line below records floors alongside rates).
    ratchet_failures = _apply_perf_ratchet(result, compact)
    print(json.dumps(result))
    # Capture-proof compact summary, printed LAST: a reader that keeps only
    # the final ~2000 chars of stdout still gets the contract fields plus
    # one headline rate per stage, however many stages the bench grows.
    print(json.dumps(compact))
    if ratchet_failures:
        # honest artifact + failing exit code: throttled-but-correct is
        # still a failed bench run
        for f in ratchet_failures:
            print(f"[bench] PERF RATCHET FAILED: {f}", file=sys.stderr,
                  flush=True)
        sys.exit(1)


_HEADLINE_KEYS = (
    "ess_per_sec", "ess_min_per_sec", "draws_per_sec",
    "replica_updates_per_sec", "particle_updates_per_sec",
    "latent_draws_per_sec", "sweeps_per_sec", "cold_draws_per_sec",
)


# ---------------------------------------------------------------------------
# Perf-regression ratchet. The quality gates above are moments/R-hat/ESS
# only — a change that made a stage 100x slower would still publish a green
# artifact. Rate floors are ~0.4x the stage's headline rate and ess_mean
# floors ~0.25x its mean ESS per timed run (catching an adaptation bug that
# halves ESS/step even when moments stay correct). Keys are the
# compact-summary stage paths; "rate" gates the stage's headline rate,
# "ess_mean" (when set) gates the recorded mean ESS per timed run. Floors
# are recorded into the stage dicts so the artifact carries them alongside
# the rates. Measured on one NVIDIA H100 80GB HBM3 at a 400 W power limit
# (XLA path, 2026-10); the comment on each line is that run's headline
# rate / mean ESS. A card at a higher power limit only reads faster.
_PERF_FLOORS = {
    "hmc_flagship": {"rate": 1.4e7, "ess_mean": 4.1e7},  # 3.43e7 / 1.63e8
    "nuts": {"rate": 7.8e6, "ess_mean": 3.0e7},  # 1.95e7 / 1.19e8
    # 1.30e7 / 2.86e8
    "nuts.preconditioned": {"rate": 5.2e6, "ess_mean": 7.2e7},
    "mh_gauss2d_65k": {"rate": 1.2e8, "ess_mean": 3.4e6},  # 2.96e8 / 1.35e7
    "gibbs_mixture_65k": {"rate": 3.3e8},  # 8.37e8
    "poisson_mh_65k": {"rate": 1.7e9},  # 4.20e9
    "hmc_d10000": {"rate": 1.8e4},  # 4.57e4
    "hmc_d10000_1024c": {"rate": 1.5e6, "ess_mean": 9.4e3},  # 3.85e6 / 3.77e4
    "mala_tuned_65k": {"rate": 1.6e8, "ess_mean": 6.9e6},  # 4.10e8 / 2.78e7
    "chees_65k": {"rate": 1.7e8, "ess_mean": 2.9e7},  # 4.14e8 / 1.17e8
    "ensemble_65k": {"rate": 1.7e7},  # 4.24e7
    "tempering_bimodal_8k": {"rate": 1.6e9},  # 4.01e9
    "slice_gauss2d_65k": {"rate": 4.1e6},  # 1.02e7
    "elliptical_gp64_4k": {"rate": 2.6e6},  # 6.58e6
    "ais_evidence_65k": {"rate": 1.8e9},  # 4.50e9
    "sgld_minibatch_65k_rows": {"rate": 4.5e7},  # 1.14e8
    "sgld_data_parallel_65k_rows": {"rate": 4.5e7},  # 1.12e8
    "psgld_anisotropic_100x": {"rate": 1.1e8},  # 2.87e8
    "sghmc_minibatch_65k_rows": {"rate": 4.6e7},  # 1.14e8
    # 1.10e6 / 4.39e6
    "eight_schools_10d.nuts_diag_metric": {"rate": 4.4e5, "ess_mean": 1.1e6},
    # 8.72e6 / 1.86e6
    "eight_schools_10d.chees_adapted": {"rate": 3.5e6, "ess_mean": 4.6e5},
}


def _stage_by_path(detail: dict, path: str):
    """Resolve a compact-summary stage path to its dict in ``detail``
    (``"hmc_flagship"`` = the top-level detail block itself)."""
    if path == "hmc_flagship":
        return detail
    node = detail
    for part in path.split("."):
        node = node.get(part) if isinstance(node, dict) else None
    return node if isinstance(node, dict) else None


def _apply_perf_ratchet(result: dict, compact: dict) -> list:
    """Gate each stage's headline rate (and recorded ess_mean where
    floored) against the checked-in ratchet; gate the flagship value
    against the 1e6 north star explicitly. Mutates the stage dicts to
    record their floors and the compact line with a pass/fail marker;
    returns the violation list (empty = passed)."""
    failures = []
    if result["value"] < BASELINE_ESS_PER_SEC:
        failures.append(
            f"flagship value {result['value']:.3g} < north star "
            f"{BASELINE_ESS_PER_SEC:g}"
        )
    stages = compact["stages"]
    for name, floors in _PERF_FLOORS.items():
        stage = _stage_by_path(result["detail"], name)
        if stage is not None:
            stage["perf_floor_rate"] = floors["rate"]
            if "ess_mean" in floors:
                stage["perf_floor_ess_mean"] = floors["ess_mean"]
        rate = stages.get(name)
        if not isinstance(rate, (int, float)):
            failures.append(
                f"{name}: stage missing or gate-failed "
                f"(rate floor {floors['rate']:g})"
            )
            continue
        if rate < floors["rate"]:
            failures.append(
                f"{name}: rate {rate:g} < floor {floors['rate']:g}"
            )
        em_floor = floors.get("ess_mean")
        if em_floor is not None and stage is not None:
            em = stage.get("ess_mean")
            if not isinstance(em, (int, float)) or em < em_floor:
                failures.append(
                    f"{name}: ess_mean {em} < floor {em_floor:g}"
                )
    compact["perf_ratchet"] = (
        "passed" if not failures else [f[:100] for f in failures[:4]]
    )
    return failures


def _compact_summary(result: dict) -> dict:
    """One ≤1.5 KB line: contract fields + {stage: headline_rate}."""

    def headline(stage: dict):
        for k in _HEADLINE_KEYS:
            if k in stage:
                return float(f"{stage[k]:.4g}")
        for k, v in stage.items():
            if k.endswith("_per_sec") and isinstance(v, (int, float)):
                return float(f"{v:.4g}")
        return "passed"

    detail = result["detail"]
    stages = {"hmc_flagship": float(f"{result['value']:.4g}")}
    n_passed = 1 if detail.get("quality_gate") == "passed" else 0
    todo = [(name, stage) for name, stage in detail.items()]
    while todo:
        name, stage = todo.pop(0)
        if name.endswith("_gate_failed"):
            stages[f"{name[:-12]}_FAILED"] = str(stage)[:160]
            continue
        if not (isinstance(stage, dict) and "quality_gate" in stage):
            continue
        ok = stage["quality_gate"] == "passed"
        n_passed += ok
        stages[name] = headline(stage) if ok else "FAILED"
        todo.extend((f"{name}.{k}", v) for k, v in stage.items()
                    if isinstance(v, dict) and "quality_gate" in v)
    return {
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": result["vs_baseline"],
        "stages_passed": n_passed,
        "stages": stages,
    }


if __name__ == "__main__":
    main("--extra" in sys.argv[1:])
