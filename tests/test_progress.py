"""Progress display tests: per-chain bars, rotation, NUTS conventions.

The reference shows one global bar plus up to five per-chain bars with
per-chain p(accept), rotating through chain indices
(/root/reference/src/core.rs:229-324). The lockstep display mirrors that
layout; rotation rides the stats tick (chains finish simultaneously here).
"""

import io

import jax.numpy as jnp
import numpy as np

from mini_mcmc_tpu import NUTS, MetropolisHastings, init_det
from mini_mcmc_tpu.models import (
    diffable_gaussian2d,
    gaussian2d,
    isotropic_gaussian_proposal,
)
from mini_mcmc_tpu.progress import _MAX_CHAIN_BARS, _ProgressDisplay


def test_run_progress_renders_per_chain_bars():
    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    proposal = isotropic_gaussian_proposal(1.0)
    mh = MetropolisHastings(target, proposal, init_det(8, 2)).seed(1)
    out = io.StringIO()
    sample, stats = mh.run_progress(60, 20, stream=out)
    text = out.getvalue()
    assert sample.shape == (8, 60, 2)
    assert "Global" in text and "max(rhat)≈" in text
    # per-chain entries with per-chain p(accept) (core.rs:275-276)
    for idx in range(_MAX_CHAIN_BARS):
        assert f"Chain {idx}" in text, text[-500:]
    assert text.count("p(accept)≈") >= _MAX_CHAIN_BARS + 1
    # the final stats tick rotates one slot, so a chain beyond the first
    # five appears over the course of the run (rotation parity)
    assert "Chain 5" in text


def test_display_rotation_walks_all_chains_then_stops():
    disp = _ProgressDisplay(7, 100, io.StringIO())
    assert disp.active == [0, 1, 2, 3, 4]
    disp.rotate()
    assert disp.active == [1, 2, 3, 4, 5]
    disp.rotate()
    assert disp.active == [2, 3, 4, 5, 6]
    disp.rotate()  # all chains shown once -> rotation stops (core.rs:308)
    assert disp.active == [2, 3, 4, 5, 6]


def test_display_fewer_chains_than_bars():
    disp = _ProgressDisplay(3, 100, io.StringIO())
    assert disp.active == [0, 1, 2]
    disp.rotate()
    assert disp.active == [0, 1, 2]
    disp.render(50, 0.5, jnp.full((3,), 0.5), 1.0, 1.0)


def _nuts(n_chains=8, seed=3):
    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    return NUTS(target, init_det(n_chains, 2), 0.8).seed(seed)


def test_nuts_run_progress_no_discard_records_initial_row():
    # n_discard=0: the first recorded row is the position at collection
    # start (initial-recording convention, nuts.rs:457-470)
    nuts = _nuts()
    before = np.asarray(nuts.positions)
    out = io.StringIO()
    sample, stats = nuts.run_progress(20, 0, stream=out)
    assert sample.shape == (8, 20, 2)
    np.testing.assert_array_equal(np.asarray(sample[:, 0, :]), before)
    # rows advance after the first
    assert not np.allclose(np.asarray(sample[:, 1, :]), before)
    assert "Chain 0" in out.getvalue()


def test_nuts_run_progress_single_collect():
    # n_collect=1, n_discard=0 degenerates to just the initial row
    nuts = _nuts()
    before = np.asarray(nuts.positions)
    sample, stats = nuts.run_progress(1, 0, stream=io.StringIO())
    assert sample.shape == (8, 1, 2)
    np.testing.assert_array_equal(np.asarray(sample[:, 0, :]), before)


def test_nuts_run_progress_with_discard_matches_run_convention():
    # total step count must equal run()'s n_collect + n_discard - 1; and
    # the two collection conventions must agree statistically
    nuts = _nuts(n_chains=16, seed=0)
    sample_p, stats_p = nuts.run_progress(400, 100, stream=io.StringIO())
    assert sample_p.shape == (16, 400, 2)

    nuts2 = _nuts(n_chains=16, seed=1)
    sample_r = nuts2.run(400, 100)
    a = np.asarray(sample_p).reshape(-1, 2)
    b = np.asarray(sample_r).reshape(-1, 2)
    np.testing.assert_allclose(a.mean(axis=0), b.mean(axis=0), atol=0.25)
    np.testing.assert_allclose(a.var(axis=0), b.var(axis=0), atol=0.6)
    # both near the true target moments (mean [0,1], var [4,3])
    np.testing.assert_allclose(a.mean(axis=0), [0.0, 1.0], atol=0.3)
    np.testing.assert_allclose(a.var(axis=0), [4.0, 3.0], atol=0.8)


def _mh(seed=1, **kw):
    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    return MetropolisHastings(target, isotropic_gaussian_proposal(1.0),
                              init_det(8, 2), **kw).seed(seed)


def test_run_progress_time_major_matches_chain_major():
    # the time-major progress path must produce the SAME draws as the
    # chain-major one (identical chunk/key schedule; only the cube layout
    # differs), with the [N, C, D] shape
    a, _ = _mh(seed=5).run_progress(30, 10, stream=io.StringIO())
    b, _ = _mh(seed=5).run_progress(30, 10, stream=io.StringIO(),
                                    time_major=True)
    assert a.shape == (8, 30, 2) and b.shape == (30, 8, 2)
    np.testing.assert_array_equal(np.asarray(a),
                                  np.swapaxes(np.asarray(b), 0, 1))


def test_run_progress_drives_block_runner_with_tail():
    # a steps-per-call sampler's progress path must drive the BLOCK runner
    # for the K-aligned bulk (headless and monitored
    # runs share the same kernel) and the per-step runner for the sub-K
    # tail; totals that are NOT K-multiples must still work exactly
    mh = _mh(seed=2, steps_per_call=4)
    calls = []
    block_runner = mh._progress_runner
    tail_runner = mh._progress_tail_runner
    assert block_runner is not tail_runner

    def spy_block(state, key, c, d, **kw):
        calls.append(("block", c))
        return block_runner(state, key, c, d, **kw)

    def spy_tail(state, key, c, d, **kw):
        calls.append(("tail", c))
        return tail_runner(state, key, c, d, **kw)

    mh._progress_runner = spy_block
    mh._progress_tail_runner = spy_tail
    sample, stats = mh.run_progress(25, 10, stream=io.StringIO())
    assert sample.shape == (8, 25, 2)
    kinds = {k for k, _ in calls}
    assert kinds == {"block", "tail"}, calls
    assert all(c % 4 == 0 for k, c in calls if k == "block"), calls
    assert sum(c for _, c in calls) == 35, calls
    assert sum(c for k, c in calls if k == "tail") == 35 % 4, calls


def test_run_progress_block_statistics_match_per_step():
    # block-driven progress must stay statistically identical to the
    # per-step progress path (different key schedule, same distribution)
    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])

    def mh64(seed, **kw):
        return MetropolisHastings(target, isotropic_gaussian_proposal(1.0),
                                  init_det(64, 2), **kw).seed(seed)

    a, _ = mh64(7).run_progress(400, 100, stream=io.StringIO())
    b, _ = mh64(8, steps_per_call=8).run_progress(
        400, 100, stream=io.StringIO())
    fa, fb = (np.asarray(s).reshape(-1, 2) for s in (a, b))
    np.testing.assert_allclose(fa.mean(axis=0), fb.mean(axis=0), atol=0.2)
    np.testing.assert_allclose(fa.var(axis=0), fb.var(axis=0), atol=0.5)


def test_nuts_run_progress_time_major():
    # initial-recording convention in the time-major layout: row 0 is the
    # collection-start position, shape is [N, C, D]
    nuts = _nuts()
    before = np.asarray(nuts.positions)
    sample, stats = nuts.run_progress(20, 0, stream=io.StringIO(),
                                      time_major=True)
    assert sample.shape == (20, 8, 2)
    np.testing.assert_array_equal(np.asarray(sample[0]), before)
    assert not np.allclose(np.asarray(sample[1]), before)
