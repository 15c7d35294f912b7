"""Diagnostics tests.

Mirrors the reference's stats test suite
(/root/reference/src/stats.rs:673-834): R-hat golden values from
hand-computed two-step fixtures, autocovariance FFT-vs-bruteforce on the
same inputs, and the iid-uniform ESS sanity floor (ESS.min > 3800 of 4000,
R-hat.max < 1.01).
"""

import jax
import jax.numpy as jnp
import numpy as np

from mini_mcmc_tpu import stats as S


def _rhat_after_two_steps(data0, data1):
    t = S.tracker_init(3, 4)
    t = S.tracker_update(t, jnp.asarray(data0))
    t = S.tracker_update(t, jnp.asarray(data1))
    return np.asarray(S.tracker_rhat(t))


def test_rhat_golden_1():
    # /root/reference/src/stats.rs:703-720
    data0 = [[0.0, 1.0, 0.0, 1.0], [1.0, 2.0, 0.0, 2.0], [0.0, 0.0, 0.0, 2.0]]
    data1 = [[1.0, 2.0, 2.0, 0.0], [1.0, 1.0, 1.0, 1.0], [0.0, 1.0, 0.0, 0.0]]
    expected = np.array([np.sqrt(2.0), 1.0801234, 0.8944272, 0.8660254])
    got = _rhat_after_two_steps(data0, data1)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_rhat_golden_2():
    # /root/reference/src/stats.rs:739-752
    data0 = [[1.0, 0.0, 0.0, 1.0], [1.0, 0.0, 0.0, 1.0], [0.0, 1.0, 0.0, 2.0]]
    data1 = [[1.0, 2.0, 0.0, 2.0], [1.0, 2.0, 0.0, 0.0], [2.0, 0.0, 1.0, 2.0]]
    expected = np.array([1.0 / np.sqrt(2.0), 0.74535599, 1.0, 1.5])
    got = _rhat_after_two_steps(data0, data1)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_autocov_single_param_golden():
    # /root/reference/src/stats.rs:777-789
    data = jnp.array([[1.0], [2.0], [3.0], [4.0]])
    expected = np.array([[1.25], [0.3125], [-0.375], [-0.5625]])
    np.testing.assert_allclose(np.asarray(S.autocov_bf(data)), expected, atol=1e-6)
    np.testing.assert_allclose(np.asarray(S.autocov_fft(data)), expected, atol=1e-5)


def test_autocov_two_params_golden():
    # /root/reference/src/stats.rs:794-808
    data = jnp.array([[1.0, 0.3], [2.0, 2.0], [3.0, -2.0], [4.0, 5.0]])
    expected = np.array(
        [
            [1.25, 6.516875],
            [0.3125, -3.7889063],
            [-0.375, 1.4721875],
            [-0.5625, -0.94171875],
        ]
    )
    np.testing.assert_allclose(np.asarray(S.autocov_bf(data)), expected, atol=1e-5)
    np.testing.assert_allclose(np.asarray(S.autocov_fft(data)), expected, atol=1e-4)


def test_autocov_bf_vs_fft_random():
    # FFT and brute force agree on random inputs of several lengths.
    for n in [5, 17, 64, 130]:
        x = jax.random.normal(jax.random.PRNGKey(n), (n, 3), jnp.float32)
        bf = np.asarray(S.autocov_bf(x))
        fft = np.asarray(S.autocov_fft(x))
        np.testing.assert_allclose(bf, fft, atol=1e-4)


def test_ess_iid_uniforms_sanity():
    # /root/reference/src/stats.rs:810-834: 4 chains x 1000 iid uniforms:
    # ESS.min > 3800, rhat.max < 1.01.
    key = jax.random.PRNGKey(42)
    data = jax.random.uniform(key, (4, 1000, 1), jnp.float32)
    rs = S.run_stats(data)
    assert rs.ess.min > 3800.0, rs.ess
    assert rs.rhat.max < 1.01, rs.rhat


def test_split_rhat_detects_nonconvergence():
    # Two chains at different levels: split R-hat far from 1, ESS tiny.
    key = jax.random.PRNGKey(0)
    a = jax.random.normal(key, (1, 500, 1)) + 10.0
    b = jax.random.normal(jax.random.fold_in(key, 1), (1, 500, 1)) - 10.0
    sample = jnp.concatenate([a, b], axis=0)
    rhat, ess = S.split_rhat_mean_ess(sample)
    # reference's split-rhat is sqrt(W/var) which goes to ~0 on divergence
    assert float(rhat[0]) < 0.5
    assert float(ess[0]) < 50.0


def test_splitcat_odd_length_drops_middle():
    # (C, n, P) with odd n: first n//2 and last n//2 rows; the middle
    # element is dropped (stats.rs:396-402 slices ..half and -half..).
    x = jnp.arange(5, dtype=jnp.float32).reshape(1, 5, 1)
    splitted = S._splitcat(x)
    assert splitted.shape == (2, 2, 1)
    np.testing.assert_array_equal(
        np.asarray(splitted).ravel(), [0.0, 1.0, 3.0, 4.0]
    )


def test_geyer_tau_breaks_at_first_nonpositive_pair():
    # Pairs: (1.0+0.5)=1.5, (0.2+(-0.3))=-0.1 <= 0 -> stop after first.
    rho = jnp.array([[1.0], [0.5], [0.2], [-0.3], [0.4], [0.4]], jnp.float32)
    tau = float(S._geyer_tau(rho)[0])
    assert np.isclose(tau, -1.0 + 2.0 * 1.5)
    # Monotone clipping: pair sums 1.5, 1.0, 1.2 -> clipped to 1.5, 1.0, 1.0
    rho2 = jnp.array(
        [[1.0], [0.5], [0.6], [0.4], [0.7], [0.5]], jnp.float32
    )
    tau2 = float(S._geyer_tau(rho2)[0])
    assert np.isclose(tau2, -1.0 + 2.0 * (1.5 + 1.0 + 1.0))


def test_tracker_streaming_moments_match_batch():
    key = jax.random.PRNGKey(7)
    data = jax.random.normal(key, (20, 3, 2), jnp.float32)  # [steps, C, P]
    t = S.tracker_init(3, 2)
    for i in range(20):
        t = S.tracker_update(t, data[i])
    cs = S.tracker_stats(t)
    np.testing.assert_allclose(
        np.asarray(cs.mean), np.asarray(jnp.mean(data, axis=0)), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(cs.sm2),
        np.asarray(jnp.var(data, axis=0, ddof=1)),
        rtol=1e-4,
        atol=1e-5,
    )


def test_tracker_p_accept_ewma():
    # All-change steps push p_accept towards 1 with alpha=0.01 per chain-row
    # update (stats.rs:13, :250-255).
    t = S.tracker_init(2, 1)
    x = jnp.zeros((2, 1))
    expected = 0.0
    for i in range(50):
        x = x + 1.0
        t = S.tracker_update(t, x)
        for _ in range(2):
            expected = (1 - S.ALPHA) * expected + S.ALPHA * 1.0
    assert np.isclose(float(t.p_accept), expected, atol=1e-6)


def test_collect_rhat_live():
    # Live collect_rhat runs and produces finite positive values.
    means = jnp.array([[0.1, 0.2], [0.0, 0.3], [0.15, 0.1]])
    sm2s = jnp.array([[1.0, 1.1], [0.9, 1.0], [1.05, 0.95]])
    ns = jnp.array([100, 100, 100])
    r = np.asarray(S.collect_rhat(means, sm2s, ns))
    assert r.shape == (2,)
    assert np.all(np.isfinite(r)) and np.all(r > 0)


def test_basic_stats_median_convention():
    # Descending sort, element at index len/2 (stats.rs:310-336).
    bs = S.basic_stats("x", jnp.array([1.0, 2.0, 3.0, 4.0]))
    assert bs.min == 1.0 and bs.max == 4.0
    assert bs.median == 2.0  # descending [4,3,2,1], index 2
    assert np.isclose(bs.mean, 2.5)
    assert np.isclose(bs.std, np.std([1, 2, 3, 4], ddof=1))


def test_run_stats_display():
    data = jax.random.uniform(jax.random.PRNGKey(3), (4, 200, 2))
    rs = S.run_stats(data)
    text = str(rs)
    assert "ESS" in text and "Split R-hat" in text


def test_split_rhat_mean_ess_time_major_matches(monkeypatch):
    # the memory-lean [N, C, P] path must agree with the chain-major one
    key = jax.random.PRNGKey(5)
    sample = jax.random.normal(key, (32, 257, 3), jnp.float32)  # odd draws
    sample = sample + 0.5 * jnp.roll(sample, 1, axis=1)
    rhat_cm, ess_cm = S.split_rhat_mean_ess(sample)
    monkeypatch.setattr(S, "_AUTOCOV_CHUNK", 20)  # exercise the chunk loop
    rhat_tm, ess_tm = S.split_rhat_mean_ess(
        jnp.swapaxes(sample, 0, 1), time_major=True
    )
    np.testing.assert_allclose(np.asarray(rhat_tm), np.asarray(rhat_cm),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ess_tm), np.asarray(ess_cm),
                               rtol=1e-4)
    # brute-force (n<=100) dispatch branch too
    short = sample[:, :64]
    rhat_cm, ess_cm = S.split_rhat_mean_ess(short)
    rhat_tm, ess_tm = S.split_rhat_mean_ess(
        jnp.swapaxes(short, 0, 1), time_major=True
    )
    np.testing.assert_allclose(np.asarray(rhat_tm), np.asarray(rhat_cm),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ess_tm), np.asarray(ess_cm),
                               rtol=1e-4)


def test_ess_chunked_autocov_matches_unchunked(monkeypatch):
    # huge-chain-count runs accumulate the mean autocovariance in chunks to
    # bound FFT scratch memory; the result must match the one-shot path
    key = jax.random.PRNGKey(0)
    sample = jax.random.normal(key, (48, 256, 3), jnp.float32)
    sample = sample + 0.5 * jnp.roll(sample, 1, axis=1)  # correlate draws
    rhat_full, ess_full = S.split_rhat_mean_ess(sample)
    monkeypatch.setattr(S, "_AUTOCOV_CHUNK", 16)  # 96 split chains -> 6 chunks
    rhat_chunk, ess_chunk = S.split_rhat_mean_ess(sample)
    np.testing.assert_allclose(np.asarray(rhat_chunk),
                               np.asarray(rhat_full), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ess_chunk),
                               np.asarray(ess_full), rtol=1e-4)


def test_basic_stats_nan_ordering_matches_reference_comparator():
    # stats.rs:312-316 sorts descending with partial_cmp falling back to
    # Equal for NaN — NaNs compare equal to everything and stay in place;
    # a NaN must not become the reported max (jnp.sort would put it there)
    bs = S.basic_stats("ESS", [3.0, float("nan"), 1.0, 2.0])
    assert bs.max == 3.0
    assert bs.min == 1.0


def _numpy_ess_no_split(sample):
    """Deliberately independent NumPy re-derivation of the reference's
    ess_from_chainstats semantics (stats.rs:668-671): NO chain splitting —
    W and pooled var come straight from the per-chain ChainStats (with the
    C*P-1 between divisor, stats.rs:173), autocovariance is the 1/n
    convention, and tau is Geyer's initial-monotone positive pair sum with
    the running-min convention (stats.rs:518-543)."""
    c, n, p = sample.shape
    means = sample.mean(axis=1)  # [C, P]
    sm2s = sample.var(axis=1, ddof=1)  # [C, P]
    within = sm2s.mean(axis=0)
    diffs = means - means.mean(axis=0, keepdims=True)
    between = (diffs**2).sum(axis=0) / (diffs.size - 1)  # C*P-1 quirk
    var = between + within * (n - 1.0) / n

    x = sample - means[:, None, :]
    acov = np.zeros((n, p))
    for lag in range(n):
        acov[lag] = (x[:, : n - lag] * x[:, lag:]).sum(axis=(0, 1)) / (c * n)
    rho = 1.0 - (within[None] - acov) / var[None]

    pairs = rho[: 2 * (n // 2)].reshape(n // 2, 2, p).sum(axis=1)
    tau = np.full(p, -1.0)
    for d in range(p):
        run_min, total = np.inf, 0.0
        for t in range(n // 2):
            if pairs[t, d] <= 0.0:
                break
            run_min = min(run_min, pairs[t, d])
            total += run_min
        tau[d] += 2.0 * total
    return (c * n) / tau, means, sm2s


def test_ess_from_chainstats_direct():
    """ess_from_chainstats had no test of its own:
    pin its no-splitting semantics against an independent NumPy
    re-derivation, and against split_rhat_mean_ess through the exact
    identity ess_split(cube) == ess_from_chainstats(pre-split cube)."""
    rng = np.random.default_rng(7)
    c, n, p = 4, 80, 3  # n <= 100: the brute-force autocov branch
    sample = np.zeros((c, n, p), np.float32)
    innov = rng.standard_normal((c, n, p)).astype(np.float32)
    for t in range(1, n):  # AR(1): real autocorrelation to sum over
        sample[:, t] = 0.6 * sample[:, t - 1] + innov[:, t]
    sample += rng.standard_normal((c, 1, p)).astype(np.float32)  # offsets

    expected, means, sm2s = _numpy_ess_no_split(sample.astype(np.float64))
    got = np.asarray(S.ess_from_chainstats(
        sample, means, sm2s, np.full(c, n, np.float32)))
    np.testing.assert_allclose(got, expected, rtol=2e-3)

    # The no-splitting var formula is NOT the split pipeline's: the
    # reference's withinvar_from_cs divides the between-chain sum by
    # C*P-1 with no n factor (stats.rs:173), while the split path uses
    # B = n * sum/(C-1) (stats.rs:429-477). Pin the quirk: feeding the
    # split-chain stats through ess_from_chainstats must NOT reproduce
    # split_rhat_mean_ess (if these ever agree, someone "fixed" one of
    # the two parity formulas).
    splitted = np.concatenate([sample[:, : n // 2], sample[:, n // 2 :]])
    ess_via_cs = np.asarray(S.ess_from_chainstats(
        splitted,
        splitted.mean(axis=1),
        splitted.var(axis=1, ddof=1),
        np.full(2 * c, n // 2, np.float32),
    ))
    _, ess_split = S.split_rhat_mean_ess(sample)
    assert np.all(np.abs(ess_via_cs / np.asarray(ess_split) - 1.0) > 0.5)

    # sanity floor: on iid draws tau ~ 1, so ESS approaches C*n
    iid = rng.standard_normal((c, n, p)).astype(np.float32)
    ess_iid = np.asarray(S.ess_from_chainstats(
        iid, iid.mean(axis=1), iid.var(axis=1, ddof=1),
        np.full(c, n, np.float32)))
    assert np.all(ess_iid > 0.7 * c * n), ess_iid
