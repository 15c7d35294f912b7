"""Benchmark harnesses and ESS quality-band studies.

The analog of the reference's ``#[ignore]``-gated benchmark tests — run
explicitly with ``pytest -m slow``:

- MH throughput harness: 80,000,000 total samples across 16 chains
  (/root/reference/src/metropolis_hastings.rs:403-413)
- MH ESS quality bands: mean ESS(x1) in [65, 125], ESS(x2) in [83, 143]
  over repeated 3-chain x 1000-draw runs (mh.rs:494-512)
- HMC ESS/R-hat quality bands: ESS in [135, 185]/[141, 191], R-hat in
  [0.95, 1.05] (hmc.rs:764-787)
- HMC high-dimension harness: d = 10,000 (hmc.rs:882-916)
- NUTS throughput harness: 6 chains x 5,000 draws Rosenbrock2D
  (nuts.rs:1251-1281)
- autocov FFT-vs-bruteforce runtime sweep (stats.rs:836-878)
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_mcmc_tpu import (
    HMC,
    NUTS,
    MetropolisHastings,
    init_det,
    split_rhat_mean_ess,
)
from mini_mcmc_tpu import stats as S
from mini_mcmc_tpu.models import (
    diffable_gaussian2d,
    gaussian2d,
    isotropic_gaussian_proposal,
    rosenbrock2d,
)

pytestmark = pytest.mark.slow

_sync = jax.block_until_ready


def test_mh_throughput_80m_samples():
    # 80M total samples over 16 chains (5M steps each); runs to completion.
    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    proposal = isotropic_gaussian_proposal(1.0)
    mh = MetropolisHastings(target, proposal, init_det(16, 2)).seed(42)
    n_steps = 80_000_000 // 16
    # chunk to bound the output cube; throughput is what matters
    chunk = 500_000
    t0 = time.monotonic()
    done = 0
    while done < n_steps:
        _sync(mh.run(min(chunk, n_steps - done), 0))
        done += chunk
    elapsed = time.monotonic() - t0
    print(f"MH 80M samples: {elapsed:.1f}s, "
          f"{80e6 / elapsed / 1e6:.2f}M samples/s")


def test_gibbs_throughput_mixture():
    # Gibbs throughput harness (the sampler the reference benches only via
    # its example, examples/mixture_gibbs.rs): 10M sweeps of the mixture
    # conditional across 256 chains with the K-sweep block path, moment
    # bands from gibbs.rs:374-386 theory.
    from mini_mcmc_tpu import GibbsSampler
    from mini_mcmc_tpu.models import gaussian_mixture_conditional

    mu0, sigma0, mu1, sigma1, pi0 = -2.0, 1.0, 3.0, 1.5, 0.5
    cond = gaussian_mixture_conditional(mu0, sigma0, mu1, sigma1, pi0)
    g = GibbsSampler(cond, jnp.zeros((256, 2)), steps_per_call=8).seed(0)
    n_steps = 10_000_000 // 256
    chunk = 8192
    t0 = time.monotonic()
    done, xs_mean, xs_sq, n_x = 0, 0.0, 0.0, 0
    while done < n_steps:
        c = min(chunk, n_steps - done)
        c -= c % 8  # block path needs K-multiples
        sample = _sync(g.run(max(c, 8), 0, time_major=True))
        x = sample[:, :, 0]
        xs_mean += float(jnp.sum(x))
        xs_sq += float(jnp.sum(x * x))
        n_x += x.size
        done += max(c, 8)
    elapsed = time.monotonic() - t0
    mean = xs_mean / n_x
    var = xs_sq / n_x - mean * mean
    true_mean = pi0 * mu0 + (1 - pi0) * mu1
    true_var = (pi0 * (sigma0**2 + (mu0 - true_mean) ** 2)
                + (1 - pi0) * (sigma1**2 + (mu1 - true_mean) ** 2))
    assert abs(mean - true_mean) < abs(true_mean) / 10.0, mean
    assert abs(var - true_var) < true_var / 10.0, var
    print(f"Gibbs 10M sweeps: {elapsed:.1f}s, "
          f"{done * 256 / elapsed / 1e6:.2f}M draws/s")


def test_mh_ess_quality_band():
    # Reference config (mh.rs:419-445): correlated Gaussian2D([0,1],
    # [[4,2],[2,3]]), IsotropicGaussian(1.0) proposal, 3 chains, 500
    # burn-in, 1000 collected; mean ESS(x1) in [65, 125], ESS(x2) in
    # [83, 143] over repeated runs (mh.rs:494-512).
    target = gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    proposal = isotropic_gaussian_proposal(1.0)
    ess_runs = []
    for rep in range(100):
        mh = MetropolisHastings(target, proposal, init_det(3, 2)).seed(rep)
        sample = mh.run(1000, 500)
        _, ess = split_rhat_mean_ess(sample)
        ess_runs.append(np.asarray(ess))
    mean_ess = np.mean(ess_runs, axis=0)
    std_ess = np.std(ess_runs, axis=0, ddof=1)
    assert 65.0 <= mean_ess[0] <= 125.0, (mean_ess, std_ess)
    assert 83.0 <= mean_ess[1] <= 143.0, (mean_ess, std_ess)


def test_hmc_quality_bands():
    # Reference config (hmc.rs:632-700): DiffableGaussian2D([0,1],
    # [[4,2],[2,3]]), 3 chains, eps=0.1, L=10, 500 discard + 1000 collect;
    # mean ESS in [135,185] (p1) / [141,191] (p2), R-hat in [0.95, 1.05]
    # (hmc.rs:764-787).
    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    rhats, esss = [], []
    for rep in range(100):
        hmc = HMC(target, init_det(3, 2), 0.1, 10).seed(rep)
        sample = hmc.run(1000, 500)
        rhat, ess = split_rhat_mean_ess(sample)
        rhats.append(np.asarray(rhat))
        esss.append(np.asarray(ess))
    mean_rhat = np.mean(rhats, axis=0)
    mean_ess = np.mean(esss, axis=0)
    assert np.all(mean_rhat >= 0.95) and np.all(mean_rhat <= 1.05), mean_rhat
    assert 135.0 <= mean_ess[0] <= 185.0, (mean_ess,)
    assert 141.0 <= mean_ess[1] <= 191.0, (mean_ess,)


def test_hmc_high_dimension_10000():
    # d = 10,000 batched HMC (hmc.rs:882-916): 6 chains, 100+100 steps on an
    # isotropic Gaussian via RosenbrockND's scale-free cousin; the reference
    # uses a standard normal-like target at this size.
    from mini_mcmc_tpu.models import standard_normal

    target = standard_normal()
    hmc = HMC(target, init_det(6, 10_000), 0.1, 10).seed(0)
    t0 = time.monotonic()
    sample = _sync(hmc.run(100, 100))
    elapsed = time.monotonic() - t0
    assert sample.shape == (6, 100, 10_000)
    print(f"HMC d=10k: {elapsed:.2f}s for 200 steps")


def test_nuts_throughput_6x5000():
    target = rosenbrock2d(1.0, 100.0)
    sampler = NUTS(target, init_det(6, 2), 0.8).seed(42)
    t0 = time.monotonic()
    sample = _sync(sampler.run(5000, 500))
    elapsed = time.monotonic() - t0
    assert sample.shape == (6, 5000, 2)
    print(f"NUTS 6x5000 Rosenbrock2D: {elapsed:.1f}s, "
          f"{6 * 5500 / elapsed:.0f} draws/s")


def test_autocov_runtime_sweep(tmp_path):
    # FFT vs brute force runtimes over lengths 2^0..2^9, written to CSV
    # (stats.rs:836-878).
    import csv

    rng = np.random.default_rng(0)
    out = tmp_path / "runtime_results.csv"
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["length", "rep", "time_ns", "algorithm"])
        for exp in range(10):
            n = 1 << exp
            data = jnp.asarray(rng.random((n, 1000), np.float32))
            for rep in range(3):
                t0 = time.monotonic_ns()
                jax.block_until_ready(S.autocov_fft(data))
                w.writerow([n, rep, time.monotonic_ns() - t0, "fft"])
                t0 = time.monotonic_ns()
                jax.block_until_ready(S.autocov_bf(data))
                w.writerow([n, rep, time.monotonic_ns() - t0, "brute force"])
    assert out.exists()


def test_slice_ess_quality_band():
    # Reference-style repeated-run ESS band (the mh.rs:494-512 tier) for
    # the beyond-reference coordinate slice sampler on the same family of
    # correlated band targets: 20 reps of 3 chains x 1000 draws. Slice's
    # per-draw efficiency on this target is ~20% of total draws (vs ~3%
    # for tuned isotropic MH); the band brackets the calibrated rep-mean
    # (610/654 per dim) with room for seed noise.
    from mini_mcmc_tpu import SliceSampler

    target = gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    reps = []
    for rep in range(20):
        init = jnp.asarray(
            np.random.default_rng(rep).standard_normal((3, 2)), jnp.float32
        )
        sl = SliceSampler(target, init).seed(rep)
        _, ess = split_rhat_mean_ess(sl.run(1000, 100))
        reps.append(np.asarray(ess))
    mean_ess = np.stack(reps).mean(axis=0)
    assert np.all(mean_ess > 480.0), mean_ess
    assert np.all(mean_ess < 820.0), mean_ess


def test_mala_ess_quality_band():
    # Same tier for MALA at a fixed near-optimal step size (eps = 2.2,
    # the dual-averaged value from the 65k-chain bench config) on the
    # reference band target: calibrated rep-mean 579/680 per dim of 3000
    # total draws (~19-23% per-draw efficiency — gradients buy ~6x over
    # tuned isotropic MH's ~3%).
    from mini_mcmc_tpu import MALA

    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    reps = []
    for rep in range(20):
        init = jnp.asarray(
            np.random.default_rng(rep).standard_normal((3, 2)), jnp.float32
        )
        ml = MALA(target, init, step_size=2.2).seed(rep)
        _, ess = split_rhat_mean_ess(ml.run(1000, 100))
        reps.append(np.asarray(ess))
    mean_ess = np.stack(reps).mean(axis=0)
    assert np.all(mean_ess > 450.0), mean_ess
    assert np.all(mean_ess < 820.0), mean_ess


def test_elliptical_ess_quality_band():
    # Same tier for elliptical slice on a conjugate Gaussian posterior
    # (prior std 2, unit-noise likelihood at 1): calibrated rep-mean
    # 1382/1335 per dim of 3000 total draws (~45% per-draw efficiency).
    from mini_mcmc_tpu import EllipticalSliceSampler
    from mini_mcmc_tpu.models import Target

    lik = Target(
        logp=lambda x: -0.5 * jnp.sum((x - 1.0) ** 2),
        logp_batch=lambda xs: -0.5 * jnp.sum((xs - 1.0) ** 2, axis=-1),
    )
    reps = []
    for rep in range(20):
        init = jnp.asarray(
            np.random.default_rng(100 + rep).standard_normal((3, 2)),
            jnp.float32,
        )
        el = EllipticalSliceSampler(lik, init, prior_scale=2.0).seed(rep)
        _, ess = split_rhat_mean_ess(el.run(1000, 100))
        reps.append(np.asarray(ess))
    mean_ess = np.stack(reps).mean(axis=0)
    assert np.all(mean_ess > 1100.0), mean_ess
    assert np.all(mean_ess < 1600.0), mean_ess
