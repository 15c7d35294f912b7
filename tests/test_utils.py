"""Timer and profiling helper coverage (reference dev_tools::Timer,
/root/reference/src/dev_tools.rs)."""

import jax.numpy as jnp

from mini_mcmc_tpu.utils import Timer, profiling


def test_timer_logs_elapsed(capsys):
    t = Timer()
    elapsed = t.log("phase one")
    out = capsys.readouterr().out
    assert "phase one" in out and "ms" in out
    assert elapsed >= 0.0
    t.reset()
    assert t.log("phase two") >= 0.0


def test_step_timer_blocks_and_times():
    result, secs = profiling.step_timer(
        lambda x: jnp.sum(x * x), jnp.ones((64, 64)), repeats=2
    )
    assert float(result) == 64.0 * 64.0
    assert secs >= 0.0


def test_chain_keys_independent_and_deterministic():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mini_mcmc_tpu import chain_keys

    keys = chain_keys(jax.random.PRNGKey(7), 16)
    assert keys.shape[0] == 16
    # deterministic
    keys2 = chain_keys(jax.random.PRNGKey(7), 16)
    np.testing.assert_array_equal(np.asarray(keys), np.asarray(keys2))
    # all distinct, and the draws they produce are uncorrelated
    raw = np.asarray(jax.vmap(jax.random.key_data)(keys)) if hasattr(
        jax.random, "key_data") else np.asarray(keys)
    assert len({tuple(r.ravel().tolist()) for r in raw}) == 16
    draws = np.asarray(
        jax.vmap(lambda k: jax.random.normal(k, (256,)))(keys)
    )
    corr = np.corrcoef(draws)
    off = corr[~np.eye(16, dtype=bool)]
    assert np.max(np.abs(off)) < 0.25, np.max(np.abs(off))
