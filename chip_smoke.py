"""Smoke test of the sampling path on a GPU.

Drives the samplers' default (XLA) path through the public entry points at
the sizes the bench runs, gates every result against ground truth, compares
the hot kernels with a float32 CPU reference computed in the same process,
and prints one JSON line last:

    python chip_smoke.py            # one GPU: every single-card phase
    python chip_smoke.py --multi    # four GPUs: sharded chains vs one card

Exits non-zero, with no result line, when JAX finds no GPU or any gate
fails. Each phase takes its sizes as arguments, so the CPU tests run the
same code at toy sizes (``tests/test_chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import poisson as scipy_poisson

from bench import ROSEN3D_X0_MEAN, ROSEN3D_X0_VAR
from mini_mcmc_tpu import (
    HMC,
    NUTS,
    GibbsSampler,
    MetropolisHastings,
    ParallelTempering,
    data_parallel_grad,
    geometric_betas,
    init_with_seed,
    split_rhat_mean_ess,
)
from mini_mcmc_tpu.models import (
    Preconditioner,
    Target,
    diffable_gaussian2d,
    gaussian2d,
    gaussian_mixture_conditional,
    isotropic_gaussian_proposal,
    poisson_target,
    precondition_target,
    random_walk_int_proposal,
    rosenbrock_nd,
    standard_normal,
)
from mini_mcmc_tpu.ops.elliptical import prior_draw
from mini_mcmc_tpu.ops.hmc import hmc_kernel
from mini_mcmc_tpu.parallel import chain_mesh, data_mesh, shard_sampler_state

REPO = os.path.dirname(os.path.abspath(__file__))


def configure_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself), else a fixed ``<checkout>/.jax_cache``. Returns the path."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def result_line(devices) -> str:
    """The contract's last line for the devices a run used."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def _gate(name, ok, info):
    # explicit raise, not `assert`: gates must survive `python -O`
    if not ok:
        raise AssertionError(f"gate FAILED [{name}]: {info}")


def _run_timed(run_once):
    """Compile + burn-in with one call, then time one steady call of the
    same signature. Returns ``(sample, first_call_s, steady_s)``."""
    t0 = time.perf_counter()
    jax.block_until_ready(run_once())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    sample = jax.block_until_ready(run_once())
    return sample, first, time.perf_counter() - t0


def _timing(first, steady, draws, ess=None):
    out = {"first_call_s": first, "steady_s": steady,
           # the first call runs the same program once more, so its excess
           # over a steady call is the compile (and transfer) time
           "compile_s": max(first - steady, 0.0),
           "draws_per_s": draws / steady}
    if ess is not None:
        out["ess_per_s"] = ess / steady
    return out


def _moments(sample):
    flat = sample.reshape(-1, sample.shape[-1])
    return (np.asarray(jnp.mean(flat, axis=0), np.float64),
            np.asarray(jnp.var(flat, axis=0), np.float64))


# -- single-card phases ------------------------------------------------------


def phase_hmc_flagship(n_chains=65536, n_draws=2048, n_leapfrog=192):
    """The bench flagship: Rosenbrock3D HMC, eps=0.02 +-30% jitter."""
    init = init_with_seed(n_chains, 3, seed=42) * 0.5 + 1.0
    hmc = HMC(rosenbrock_nd(), init, 0.02, n_leapfrog, jitter=0.3).seed(42)
    sample, first, steady = _run_timed(
        lambda: hmc.run(n_draws, 0, time_major=True))
    rhat, ess = split_rhat_mean_ess(sample, time_major=True)
    rhat_mean = float(jnp.mean(rhat))
    ess_min, ess_mean = float(jnp.min(ess)), float(jnp.mean(ess))
    mean, var = _moments(sample)
    total = n_chains * n_draws
    _gate("hmc rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("hmc ess floor", ess_min >= 0.01 * total, (ess_min, total))
    _gate("hmc x0 mean", abs(mean[0] - ROSEN3D_X0_MEAN) <= 0.05, mean[0])
    _gate("hmc x0 var", abs(var[0] - ROSEN3D_X0_VAR) <= 0.04, var[0])
    return {"rhat_mean": rhat_mean, "ess_min": ess_min, "x0_mean": mean[0],
            "x0_var": var[0], **_timing(first, steady, total, ess_mean)}


def phase_nuts(n_chains=65536, n_collect=512, n_discard=128):
    """NUTS with dual averaging on the reference's band target
    DiffableGaussian2D([0,1], [[4,2],[2,3]])."""
    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    nuts = NUTS(target, init_with_seed(n_chains, 2, seed=7), 0.8).seed(7)
    # first call: epsilon search + adaptation + compile; the second call
    # re-adapts during its discard phase on the same compiled program
    sample, first, steady = _run_timed(
        lambda: nuts.run(n_collect, n_discard))
    divergences = int(jnp.sum(nuts.last_run_divergences))
    rhat, ess = split_rhat_mean_ess(sample)
    rhat_mean = float(jnp.mean(rhat))
    ess_min, ess_mean = float(jnp.min(ess)), float(jnp.mean(ess))
    mean, var = _moments(sample)
    total = n_chains * n_collect
    _gate("nuts rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("nuts ess floor", ess_min >= 0.005 * total, (ess_min, total))
    for d, (m, v) in enumerate(((0.0, 4.0), (1.0, 3.0))):
        _gate(f"nuts mean[{d}]", abs(mean[d] - m) <= 0.08, mean[d])
        _gate(f"nuts var[{d}]", abs(var[d] - v) <= 0.4, var[d])
    _gate("nuts steady-state divergences",
          divergences <= max(n_chains // 10000, 1), divergences)
    steps = n_collect + n_discard - 1
    return {"rhat_mean": rhat_mean, "ess_min": ess_min,
            "divergences": divergences,
            **_timing(first, steady, n_chains * steps, ess_mean)}


def phase_mh_gauss(n_chains=65536, n_draws=1024):
    """Std-normal 2D Gaussian MH, isotropic sigma=1 proposal."""
    mh = MetropolisHastings(
        gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
        isotropic_gaussian_proposal(1.0), init_with_seed(n_chains, 2, seed=8),
    ).seed(8)
    sample, first, steady = _run_timed(
        lambda: mh.run(n_draws, 0, time_major=True))
    rhat, ess = split_rhat_mean_ess(sample, time_major=True)
    rhat_mean, ess_mean = float(jnp.mean(rhat)), float(jnp.mean(ess))
    mean, var = _moments(sample)
    total = n_chains * n_draws
    _gate("mh2d rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    for d in range(2):
        _gate(f"mh2d mean[{d}]", abs(mean[d]) <= 0.03, mean[d])
        _gate(f"mh2d var[{d}]", abs(var[d] - 1.0) <= 0.05, var[d])
    _gate("mh2d ess floor", ess_mean >= 0.02 * total, (ess_mean, total))
    return {"rhat_mean": rhat_mean, **_timing(first, steady, total, ess_mean)}


def phase_mh_poisson(n_chains=65536, n_collect=200, n_discard=100):
    """Discrete Poisson(4) MH on int32 states, +-1 random walk."""
    mh = MetropolisHastings(
        poisson_target(4.0), random_walk_int_proposal(),
        jnp.zeros((n_chains, 1), jnp.int32),
    ).seed(42)
    sample, first, steady = _run_timed(lambda: mh.run(n_collect, n_discard))
    ks = np.asarray(sample).ravel()
    max_err = max(abs(float(np.mean(ks == k)) - scipy_poisson.pmf(k, 4.0))
                  for k in range(11))
    _gate("poisson pmf", max_err < 0.05, max_err)
    return {"pmf_max_abs_err": max_err,
            **_timing(first, steady, n_chains * (n_collect + n_discard))}


def phase_gibbs(n_chains=65536, n_draws=1024):
    """Two-component Gaussian mixture Gibbs over [x, z]."""
    mu0, sigma0, mu1, sigma1, pi0 = -2.0, 1.0, 3.0, 1.5, 0.5
    g = GibbsSampler(
        gaussian_mixture_conditional(mu0, sigma0, mu1, sigma1, pi0),
        jnp.zeros((n_chains, 2)),
    ).seed(42)
    sample, first, steady = _run_timed(
        lambda: g.run(n_draws, 0, time_major=True))
    mean, var = _moments(sample)
    true_mean = pi0 * mu0 + (1 - pi0) * mu1
    true_var = (pi0 * (sigma0**2 + (mu0 - true_mean) ** 2)
                + (1 - pi0) * (sigma1**2 + (mu1 - true_mean) ** 2))
    rhat, _ = split_rhat_mean_ess(sample, time_major=True)
    rhat_mean = float(jnp.mean(rhat))
    _gate("gibbs x mean", abs(mean[0] - true_mean) <= 0.05, mean[0])
    _gate("gibbs x var", abs(var[0] - true_var) <= 0.25, var[0])
    _gate("gibbs z freq", abs(mean[1] - (1 - pi0)) <= 0.02, mean[1])
    _gate("gibbs rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    return {"rhat_mean": rhat_mean,
            **_timing(first, steady, n_chains * n_draws)}


def phase_tempering(n_chains=8192, n_draws=2048, n_temps=8):
    """Replica exchange on 0.3 N(-8, 0.5^2) + 0.7 N(8, 0.5^2), every chain
    started in the light mode."""
    w_plus = 0.7

    def mix(x0):
        a = jnp.log(1 - w_plus) - 0.5 * ((x0 + 8.0) / 0.5) ** 2
        b = jnp.log(w_plus) - 0.5 * ((x0 - 8.0) / 0.5) ** 2
        return jnp.logaddexp(a, b)

    pt = ParallelTempering(
        Target(logp=lambda x: mix(x[0]), logp_batch=lambda xs: mix(xs[:, 0]),
               logp_dc=lambda p: mix(p[0])),
        jnp.full((n_chains, 1), -8.0), betas=geometric_betas(n_temps, 0.01),
        proposal_std=1.0,
    ).seed(5)
    sample, first, steady = _run_timed(
        lambda: pt.run(n_draws, 0, time_major=True))
    xs = np.asarray(sample).ravel()
    frac_plus = float(np.mean(xs > 0))
    plus = xs[xs > 0]
    swap = np.asarray(pt.swap_acceptance)
    _gate("tempering mode weight", abs(frac_plus - w_plus) <= 0.05,
          frac_plus)
    _gate("tempering mode mean", abs(float(plus.mean()) - 8.0) <= 0.05,
          float(plus.mean()))
    _gate("tempering mode std", abs(float(plus.std()) - 0.5) <= 0.05,
          float(plus.std()))
    _gate("tempering swap rates alive", bool(np.all(swap > 0.05)),
          swap.tolist())
    return {"mode_weight": frac_plus, "min_swap": float(swap.min()),
            **_timing(first, steady, n_chains * n_draws)}


def phase_hmc_bigd(n_chains=1024, dim=10_000, n_draws=128, n_diag=1024):
    """Standard normal HMC at large D (eps=0.1, L=10): the bandwidth-bound
    shape. R-hat/ESS run on a contiguous slice of ``n_diag`` coordinates
    (iid coordinates, so the slice is an unbiased gate)."""
    hmc = HMC(standard_normal(), init_with_seed(n_chains, dim, seed=2),
              0.1, 10).seed(2)
    sample, first, steady = _run_timed(
        lambda: hmc.run(n_draws, n_draws, time_major=True))
    sub = jax.lax.slice(sample, (0, 0, 0),
                        (n_draws, n_chains, min(n_diag, dim)))
    rhat, ess = split_rhat_mean_ess(sub, time_major=True)
    rhat_mean, ess_mean = float(jnp.mean(rhat)), float(jnp.mean(ess))
    m, v = float(jnp.mean(sample)), float(jnp.var(sample))
    total = n_chains * n_draws
    _gate("hmc-bigd mean", abs(m) < 0.02, m)
    _gate("hmc-bigd var", abs(v - 1.0) < 0.05, v)
    _gate("hmc-bigd rhat", 0.95 <= rhat_mean <= 1.05, rhat_mean)
    _gate("hmc-bigd ess floor", ess_mean >= 0.02 * total, (ess_mean, total))
    # run(n, n) takes 2n sampler steps
    return {"rhat_mean": rhat_mean, "mean": m, "var": v,
            **_timing(first, steady, 2 * total, ess_mean)}


# -- device against the plain reference --------------------------------------

#: Normwise error bounds, max|dev - ref| / max(max|ref|, 1), float32 both:
#:   elementwise maps (gradients, whitening): a few ulp from FMA contraction
#:   and operation order -> 1e-5;
#:   reductions over up to 1e4 terms (logp) in another order -> 1e-4;
#:   an L=8 Rosenbrock trajectory: per-step rounding amplified by the
#:   integrator's local expansion (eps^2 |H| ~ 0.4 per step) -> 1e-4;
#:   full-precision (HIGHEST) float32 matmuls with D=64 -> 1e-5.
TOL_ELEMENTWISE = 1e-5
TOL_REDUCTION = 1e-4
TOL_TRAJECTORY = 1e-4
TOL_MATMUL = 1e-5


def _normwise(dev, ref) -> float:
    dev = np.asarray(dev, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(dev - ref)) / max(np.max(np.abs(ref)), 1.0))


def _on(device, fn, *args):
    """``jit(fn)`` on ``device`` with its inputs committed there."""
    args = [jax.device_put(a, device) for a in args]
    with jax.default_device(device):
        return jax.device_get(jax.jit(fn)(*args))


def phase_reference(device, ref_device, flagship=(65536, 3),
                    wide=(1024, 10_000), dense=(4096, 64)):
    """Compare the sampling path's kernels on ``device`` with the same
    code on ``ref_device`` (the CPU) in float32, each against its bound.
    Also records how far a default-precision (TF32 on this card) matmul
    would move the dense-metric and prior-draw results."""
    rng = np.random.default_rng(0)
    rosen = rosenbrock_nd()
    errs = {}

    def both(fn, *args):
        return _on(device, fn, *args), _on(ref_device, fn, *args)

    # batch_logp_and_grad at the flagship and the large-D widths
    for label, (c, d) in (("flagship", flagship), ("wide", wide)):
        x = (1.0 + 0.5 * rng.standard_normal((c, d))).astype(np.float32)
        (lp, g), (lp_r, g_r) = both(rosen.batch_logp_and_grad, x)
        errs[f"logp_{label}"] = _normwise(lp, lp_r)
        errs[f"grad_{label}"] = _normwise(g, g_r)
        _gate(f"logp {label}", errs[f"logp_{label}"] <= TOL_REDUCTION,
              errs[f"logp_{label}"])
        _gate(f"grad {label}", errs[f"grad_{label}"] <= TOL_ELEMENTWISE,
              errs[f"grad_{label}"])

    # one L=8 leapfrog trajectory of the production integrator from fixed
    # momenta, at the flagship width
    _, step_fn = hmc_kernel(rosen, 0.02, 8)
    c, d = flagship
    x = (1.0 + 0.5 * rng.standard_normal((c, d))).astype(np.float32)
    mom = rng.standard_normal((c, d)).astype(np.float32)

    def trajectory(pos, mom):
        logp, grad = rosen.batch_logp_and_grad(pos)
        return step_fn.leapfrog(pos, mom, logp, grad, jnp.float32(0.02))

    out, out_r = both(trajectory, x, mom)
    errs["leapfrog_L8"] = max(_normwise(a, b) for a, b in zip(out, out_r))
    _gate("leapfrog L=8", errs["leapfrog_L8"] <= TOL_TRAJECTORY,
          errs["leapfrog_L8"])

    # dense-metric whitened Gaussian at D=64 (precondition.py to_x and
    # grad_to_y), and the elliptical prior draw nu @ chol.T
    c, d = dense
    a = rng.standard_normal((d, d))
    chol = np.linalg.cholesky(a @ a.T / d + np.eye(d)).astype(np.float32)
    y = rng.standard_normal((c, d)).astype(np.float32)

    def whitened(dev):
        pre = Preconditioner(kind="dense", chol=jax.device_put(chol, dev))
        target = precondition_target(standard_normal(), pre)
        return _on(dev, target.batch_logp_and_grad, y)

    (lp, g), (lp_r, g_r) = whitened(device), whitened(ref_device)
    errs["dense_metric_logp"] = _normwise(lp, lp_r)
    errs["dense_metric_grad"] = _normwise(g, g_r)
    _gate("dense metric logp", errs["dense_metric_logp"] <= TOL_MATMUL,
          errs["dense_metric_logp"])
    _gate("dense metric grad", errs["dense_metric_grad"] <= TOL_MATMUL,
          errs["dense_metric_grad"])

    key = jax.random.PRNGKey(9)
    nu, nu_r = both(lambda k, l: prior_draw(k, l, c), key, chol)
    errs["prior_draw"] = _normwise(nu, nu_r)
    _gate("prior draw", errs["prior_draw"] <= TOL_MATMUL, errs["prior_draw"])

    # the same products with the precision left at default: recorded, not
    # gated (TF32 keeps about three decimal digits)
    def default_to_x(y, chol):
        return y @ chol.T

    dx, dx_r = both(default_to_x, y, chol)
    errs["default_precision_to_x"] = _normwise(dx, dx_r)
    return errs


# -- several cards -----------------------------------------------------------


def phase_multi(devices, n_chains=65536, n_draws=256, n_leapfrog=192):
    """Sharded flagship HMC over ``chain_mesh`` on ``devices`` with the
    live tracker (cross-chain collectives in the scan), one
    ``data_parallel_grad`` psum step, and the same work on one card."""
    n_dev = len(devices)
    mesh = chain_mesh(devices=devices)
    init = init_with_seed(n_chains, 3, seed=42) * 0.5 + 1.0

    def sampler():
        return HMC(rosenbrock_nd(), init, 0.02, n_leapfrog,
                   jitter=0.3).seed(42)

    sharded = sampler()
    sharded.state = shard_sampler_state(mesh, sharded.state)
    shard_rows = {s.data.shape[0]
                  for s in sharded.state.positions.addressable_shards}
    _gate("a quarter of the chains per card" if n_dev == 4
          else "equal chain shards per card",
          shard_rows == {n_chains // n_dev}, shard_rows)
    t0 = time.perf_counter()
    sample, stats = sharded.run_progress(n_draws, n_draws,
                                         stream=io.StringIO())
    sample = np.asarray(jax.block_until_ready(sample))
    t_sharded = time.perf_counter() - t0

    single = sampler()
    single.state = jax.device_put(single.state, devices[0])
    t0 = time.perf_counter()
    ref, ref_stats = single.run_progress(n_draws, n_draws,
                                         stream=io.StringIO())
    ref = np.asarray(jax.block_until_ready(ref))
    t_single = time.perf_counter() - t0

    # Same keys, same per-chain arithmetic: draws agree to float32
    # rounding unless a rounding difference flips an accept, which then
    # decorrelates that one chain. Bound: 99.9% of chains within 1e-4
    # everywhere, and the cross-chain moments within 1e-3.
    per_chain = np.max(np.abs(sample - ref), axis=(1, 2))
    frac_close = float(np.mean(per_chain <= 1e-4))
    moment_err = float(np.max(np.abs(sample.mean(axis=(0, 1))
                                     - ref.mean(axis=(0, 1)))))
    _gate("sharded vs one card: chains within 1e-4", frac_close >= 0.999,
          frac_close)
    _gate("sharded vs one card: moments within 1e-3", moment_err <= 1e-3,
          moment_err)

    # one data_parallel_grad step (one psum over the data mesh) against
    # the same stratified minibatch summed on one card
    n_rows, d_lr, batch = 4096 * n_dev, 8, 256 * n_dev
    rng = np.random.default_rng(0)
    x_lr = (rng.standard_normal((n_rows, d_lr)) / np.sqrt(d_lr)).astype(
        np.float32)
    y_lr = rng.standard_normal(n_rows).astype(np.float32)
    w = rng.standard_normal((64, d_lr)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def log_prior(w):
        return -0.5 * jnp.sum(w * w)

    def log_like(w, b):
        # full precision, like the reference below: this checks the psum,
        # not TF32
        return -0.5 * jnp.sum((b[1] - jnp.matmul(
            b[0], w, precision=jax.lax.Precision.HIGHEST)) ** 2)

    grad_fn = data_parallel_grad(log_prior, log_like, (x_lr, y_lr), batch,
                                 mesh=data_mesh(devices=devices))
    g = np.asarray(jax.block_until_ready(grad_fn(jnp.asarray(w), key)))
    n_loc, b_loc = n_rows // n_dev, batch // n_dev
    rows = np.concatenate([
        s * n_loc + np.asarray(jax.random.randint(
            jax.random.fold_in(key, s), (b_loc,), 0, n_loc))
        for s in range(n_dev)])
    with jax.default_device(devices[0]):
        xb, yb = jnp.asarray(x_lr[rows]), jnp.asarray(y_lr[rows])
        g_ref = np.asarray(-jnp.asarray(w) + (n_rows / batch) * jnp.matmul(
            yb[None, :] - jnp.matmul(jnp.asarray(w), xb.T,
                                     precision=jax.lax.Precision.HIGHEST),
            xb, precision=jax.lax.Precision.HIGHEST))
    psum_err = _normwise(g, g_ref)
    _gate("data_parallel_grad psum step", psum_err <= TOL_REDUCTION,
          psum_err)
    return {"n_devices": n_dev, "chains_per_card": n_chains // n_dev,
            "frac_chains_within_1e-4": frac_close,
            "max_abs_draw_diff": float(np.max(per_chain)),
            "moment_err": moment_err, "psum_grad_err": psum_err,
            "sharded_s": t_sharded, "single_s": t_single,
            "rhat_mean_sharded": stats.rhat.mean,
            "rhat_mean_single": ref_stats.rhat.mean}


# -- driver ------------------------------------------------------------------

SINGLE_PHASES = (
    ("hmc_flagship", phase_hmc_flagship),
    ("nuts", phase_nuts),
    ("mh_gauss2d", phase_mh_gauss),
    ("mh_poisson", phase_mh_poisson),
    ("gibbs_mixture", phase_gibbs),
    ("tempering_bimodal", phase_tempering),
    ("hmc_d10000", phase_hmc_bigd),
)


def _fmt(metrics: dict) -> str:
    return " ".join(
        f"{k}={float(v) if isinstance(v, np.floating) else v!r}"
        for k, v in metrics.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform "
              f"{devices[0].platform!r}); nothing measured",
              file=sys.stderr)
        return 2
    cache = configure_compile_cache()
    card = card_line()
    print(f"device: kind={devices[0].device_kind!r} count={len(devices)} "
          f"jax={jax.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
          f"compile_cache={cache!r}", flush=True)
    print(f"card: {card}", flush=True)

    if args.multi:
        if len(devices) < 4:
            print(f"chip_smoke --multi needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        used = devices[:4]
        print(f"multi: {_fmt(phase_multi(used))} [{card}]", flush=True)
    else:
        used = devices[:1]
        for name, phase in SINGLE_PHASES:
            t0 = time.perf_counter()
            metrics = phase()
            print(f"{name}: {_fmt(metrics)} "
                  f"phase_s={time.perf_counter() - t0:.1f} [{card}]",
                  flush=True)
        errs = phase_reference(devices[0], jax.devices("cpu")[0])
        print(f"reference: {_fmt(errs)}", flush=True)
    print(result_line(used), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
