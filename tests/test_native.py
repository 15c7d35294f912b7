"""Cross-validation: native C++ oracle vs the XLA diagnostics.

The framework-independent C++ implementation (native/mcmc_native.cpp) must
agree with mini_mcmc_tpu.stats on the same inputs — the whole-pipeline
analog of the reference's FFT-vs-bruteforce cross-checks
(/root/reference/src/stats.rs:777-808).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mini_mcmc_tpu import native
from mini_mcmc_tpu import stats as S

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def test_native_autocov_matches_jax():
    x = np.random.default_rng(0).normal(size=(64, 5)).astype(np.float32)
    got = native.autocov_bf(x)
    want = np.asarray(S.autocov_bf(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_native_autocov_golden():
    data = np.array([[1.0], [2.0], [3.0], [4.0]], np.float32)
    expected = np.array([[1.25], [0.3125], [-0.375], [-0.5625]], np.float32)
    np.testing.assert_allclose(native.autocov_bf(data), expected, atol=1e-6)


def test_native_geyer_tau_matches_jax():
    rng = np.random.default_rng(1)
    # decaying positive-then-negative rho columns
    n, p = 40, 4
    lags = np.arange(n)[:, None]
    rho = (0.8 ** lags) * rng.uniform(0.5, 1.5, (1, p)) - 0.01 * lags
    rho = rho.astype(np.float32)
    got = native.geyer_tau(rho)
    want = np.asarray(S._geyer_tau(jnp.asarray(rho)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_native_full_pipeline_matches_jax():
    rng = np.random.default_rng(2)
    # AR(1)-ish chains so the ESS is non-trivial
    c, n, p = 4, 120, 3
    x = np.empty((c, n, p), np.float32)
    eps = rng.normal(size=(c, n, p))
    x[:, 0] = eps[:, 0]
    for t in range(1, n):
        x[:, t] = 0.7 * x[:, t - 1] + eps[:, t]
    rhat_n, ess_n = native.split_rhat_ess(x)
    rhat_j, ess_j = S.split_rhat_mean_ess(jnp.asarray(x))
    np.testing.assert_allclose(rhat_n, np.asarray(rhat_j), rtol=1e-4)
    np.testing.assert_allclose(ess_n, np.asarray(ess_j), rtol=2e-3)


def test_native_pipeline_on_real_sampler_output():
    from mini_mcmc_tpu import MetropolisHastings, init_det
    from mini_mcmc_tpu.models import gaussian2d, isotropic_gaussian_proposal

    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    mh = MetropolisHastings(
        target, isotropic_gaussian_proposal(1.0), init_det(4, 2)
    ).seed(42)
    sample = np.asarray(mh.run(400, 100))
    rhat_n, ess_n = native.split_rhat_ess(sample)
    rhat_j, ess_j = S.split_rhat_mean_ess(jnp.asarray(sample))
    np.testing.assert_allclose(rhat_n, np.asarray(rhat_j), rtol=1e-3)
    np.testing.assert_allclose(ess_n, np.asarray(ess_j), rtol=5e-3)


def test_native_pipeline_randomized_shape_sweep():
    # randomized cross-validation across the dispatch-relevant shape axes:
    # odd/even N, the n' <= 100 brute-force branch vs FFT, minimum C=2,
    # single-parameter P, and different mixing speeds — every (shape,
    # phi) cell must agree between the independent C++ implementation,
    # the chain-major XLA path, and the time-major XLA path
    rng = np.random.default_rng(7)
    # the dispatch runs on the SPLIT length n' = n//2 (stats.py:_ess
    # switches at n' <= 100), so the FFT cells need n >= 202
    for c, n, p, phi in [
        (2, 41, 1, 0.3),   # odd N, brute-force branch, min chains
        (3, 250, 2, 0.9),  # slow mixing, FFT branch (n' = 125)
        (8, 301, 4, 0.0),  # iid, odd N, FFT branch (n' = 150)
        (5, 64, 3, -0.5),  # antithetic, brute-force branch
    ]:
        eps = rng.normal(size=(c, n, p))
        x = np.empty((c, n, p), np.float32)
        x[:, 0] = eps[:, 0]
        for t in range(1, n):
            x[:, t] = phi * x[:, t - 1] + eps[:, t]
        rhat_n, ess_n = native.split_rhat_ess(x)
        rhat_j, ess_j = S.split_rhat_mean_ess(jnp.asarray(x))
        rhat_t, ess_t = S.split_rhat_mean_ess(
            jnp.swapaxes(jnp.asarray(x), 0, 1), time_major=True
        )
        cfg = (c, n, p, phi)
        np.testing.assert_allclose(rhat_n, np.asarray(rhat_j), rtol=1e-4,
                                   err_msg=str(cfg))
        np.testing.assert_allclose(ess_n, np.asarray(ess_j), rtol=5e-3,
                                   err_msg=str(cfg))
        np.testing.assert_allclose(np.asarray(rhat_t), np.asarray(rhat_j),
                                   rtol=1e-5, err_msg=str(cfg))
        np.testing.assert_allclose(np.asarray(ess_t), np.asarray(ess_j),
                                   rtol=1e-3, err_msg=str(cfg))


def _diag_pair(cube):
    from mini_mcmc_tpu import rank_normalized_diagnostics

    d = rank_normalized_diagnostics(cube)
    rb, rf, eb, et = native.rank_normalized_diag(cube)
    return d, (rb, rf, eb, et)


def _assert_diag_close(cube, rtol_rhat=1e-4, rtol_ess=2e-3):
    d, (rb, rf, eb, et) = _diag_pair(cube)
    np.testing.assert_allclose(np.asarray(d.rhat_bulk), rb, rtol=rtol_rhat)
    np.testing.assert_allclose(np.asarray(d.rhat_folded), rf,
                               rtol=rtol_rhat)
    np.testing.assert_allclose(np.asarray(d.ess_bulk), eb, rtol=rtol_ess)
    np.testing.assert_allclose(np.asarray(d.ess_tail), et, rtol=rtol_ess)


def test_native_rank_normalized_autocorrelated():
    # AR(1) chains: real autocorrelation through BOTH the rank transform
    # and the Geyer sum; n' = 200 exercises the FFT branch of the XLA
    # pipeline against the C++ brute force (the
    # rank-normalized path previously had only property tests — a wrong
    # Blom offset or folding point would have survived them).
    rng = np.random.default_rng(0)
    c, n, p = 6, 400, 3
    cube = np.zeros((c, n, p), np.float32)
    innov = rng.standard_normal((c, n, p)).astype(np.float32)
    for t in range(1, n):
        cube[:, t] = 0.7 * cube[:, t - 1] + innov[:, t]
    _assert_diag_close(cube)


def test_native_rank_normalized_heavy_tailed():
    # Cauchy draws: classic (moment-based) R-hat is undefined here — the
    # rank transform is exactly what makes the diagnostic meaningful, so
    # the two implementations must agree on it (and the well-mixed iid
    # cube must read as converged in both).
    rng = np.random.default_rng(1)
    cube = rng.standard_cauchy((8, 160, 2)).astype(np.float32)
    d, (rb, rf, eb, et) = _diag_pair(cube)
    _assert_diag_close(cube)
    assert float(np.max(np.asarray(d.rhat))) < 1.02
    assert float(np.min(eb)) > 0.5 * 8 * 160


def test_native_rank_normalized_scale_mismatch():
    # Chains agreeing in location but differing 3x in scale: bulk R-hat
    # is blind to this (means match), the FOLDED R-hat is the detector —
    # both implementations must flag it, and agree on the value.
    rng = np.random.default_rng(2)
    cube = rng.standard_normal((4, 300, 2)).astype(np.float32)
    cube[2:] *= 3.0
    d, (rb, rf, eb, et) = _diag_pair(cube)
    _assert_diag_close(cube)
    assert np.all(rf > 1.15), rf
    assert np.all(rf > rb + 0.1), (rf, rb)


def test_native_rank_normalized_location_mismatch():
    # A stuck chain offset by +5: bulk rank-normalized R-hat must fire in
    # both implementations, and tail ESS must collapse (the offset chain
    # owns the upper tail).
    rng = np.random.default_rng(3)
    cube = rng.standard_normal((4, 300, 2)).astype(np.float32)
    cube[0] += 5.0
    d, (rb, rf, eb, et) = _diag_pair(cube)
    _assert_diag_close(cube)
    assert np.all(rb > 1.5), rb
    assert np.all(et < 100.0), et
