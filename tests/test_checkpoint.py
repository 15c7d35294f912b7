"""Checkpoint/resume tests — closes the reference's open TODO
(/root/reference/src/core.rs:134): a checkpointed run continues bit-exactly
where it left off."""

import os
import tempfile

import numpy as np
import pytest

from mini_mcmc_tpu import HMC, NUTS, MetropolisHastings, init_det
from mini_mcmc_tpu.checkpoint import restore_sampler, save_sampler
from mini_mcmc_tpu.models import (
    diffable_gaussian2d,
    gaussian2d,
    isotropic_gaussian_proposal,
    rosenbrock_nd,
)


def _ckpt_path(tmpdir):
    return os.path.join(tmpdir, "ckpt")


def test_mh_checkpoint_resume_bitexact():
    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    proposal = isotropic_gaussian_proposal(1.0)
    with tempfile.TemporaryDirectory() as tmp:
        a = MetropolisHastings(target, proposal, init_det(3, 2)).seed(9)
        a.run(40, 0)
        save_sampler(_ckpt_path(tmp), a)
        cont_a = a.run(60, 0)

        b = MetropolisHastings(target, proposal, init_det(3, 2)).seed(1234)
        restore_sampler(_ckpt_path(tmp), b)
        cont_b = b.run(60, 0)
    np.testing.assert_array_equal(np.asarray(cont_a), np.asarray(cont_b))


def test_hmc_checkpoint_resume_bitexact():
    target = rosenbrock_nd()
    with tempfile.TemporaryDirectory() as tmp:
        a = HMC(target, init_det(2, 3), 0.03, 5).seed(2)
        a.run(20, 0)
        save_sampler(_ckpt_path(tmp), a)
        cont_a = a.run(20, 0)

        b = HMC(target, init_det(2, 3), 0.03, 5).seed(777)
        restore_sampler(_ckpt_path(tmp), b)
        cont_b = b.run(20, 0)
    np.testing.assert_array_equal(np.asarray(cont_a), np.asarray(cont_b))


def test_gibbs_checkpoint_resume_bitexact():
    import jax.numpy as jnp

    from mini_mcmc_tpu import GibbsSampler
    from mini_mcmc_tpu.models import gaussian_mixture_conditional

    cond = gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5)
    with tempfile.TemporaryDirectory() as tmp:
        a = GibbsSampler(cond, jnp.zeros((3, 2))).seed(6)
        a.run(40, 0)
        save_sampler(_ckpt_path(tmp), a)
        cont_a = a.run(60, 0)

        b = GibbsSampler(cond, jnp.zeros((3, 2))).seed(4321)
        restore_sampler(_ckpt_path(tmp), b)
        cont_b = b.run(60, 0)
    np.testing.assert_array_equal(np.asarray(cont_a), np.asarray(cont_b))


def test_checkpoint_npz_backend_roundtrip():
    # the no-dependency fallback format stays loadable (auto-detected)
    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    proposal = isotropic_gaussian_proposal(1.0)
    with tempfile.TemporaryDirectory() as tmp:
        a = MetropolisHastings(target, proposal, init_det(3, 2)).seed(9)
        a.run(20, 0)
        save_sampler(_ckpt_path(tmp), a, backend="npz")
        assert os.path.exists(_ckpt_path(tmp) + ".npz")
        assert not os.path.isdir(_ckpt_path(tmp) + ".orbax")
        cont_a = a.run(20, 0)
        b = MetropolisHastings(target, proposal, init_det(3, 2)).seed(0)
        restore_sampler(_ckpt_path(tmp), b)
        cont_b = b.run(20, 0)
    np.testing.assert_array_equal(np.asarray(cont_a), np.asarray(cont_b))


def test_checkpoint_default_backend_is_orbax():
    # "auto" must use orbax whenever it is importable
    pytest.importorskip("orbax.checkpoint")
    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    proposal = isotropic_gaussian_proposal(1.0)
    with tempfile.TemporaryDirectory() as tmp:
        a = MetropolisHastings(target, proposal, init_det(3, 2)).seed(9)
        save_sampler(_ckpt_path(tmp), a)
        assert os.path.isdir(_ckpt_path(tmp) + ".orbax")


def test_checkpoint_resave_removes_other_format():
    # An orbax save followed by an npz save at the same path must not leave
    # the stale .orbax directory behind — load_checkpoint prefers .orbax, so
    # a leftover would silently resume the OLD state.
    pytest.importorskip("orbax.checkpoint")
    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    proposal = isotropic_gaussian_proposal(1.0)
    with tempfile.TemporaryDirectory() as tmp:
        a = MetropolisHastings(target, proposal, init_det(3, 2)).seed(9)
        save_sampler(_ckpt_path(tmp), a, backend="orbax")
        a.run(20, 0)
        save_sampler(_ckpt_path(tmp), a, backend="npz")
        assert not os.path.isdir(_ckpt_path(tmp) + ".orbax")
        cont_a = a.run(20, 0)
        b = MetropolisHastings(target, proposal, init_det(3, 2)).seed(0)
        restore_sampler(_ckpt_path(tmp), b)  # must load the NEWER state
        cont_b = b.run(20, 0)
        np.testing.assert_array_equal(np.asarray(cont_a), np.asarray(cont_b))
        # and the reverse direction: npz shadowed by a later orbax save
        save_sampler(_ckpt_path(tmp), b, backend="orbax")
        assert not os.path.exists(_ckpt_path(tmp) + ".npz")


def test_checkpoint_restores_across_mesh_sizes():
    # Mesh portability: a state saved from an 8-device sharded run restores
    # onto the default single device, and a single-device checkpoint
    # restores sharded over the 8-device mesh — continuations match the
    # unsharded continuation.
    from mini_mcmc_tpu.parallel import chain_mesh, shard_sampler_state

    target = rosenbrock_nd()
    mesh = chain_mesh()
    with tempfile.TemporaryDirectory() as tmp:
        a = HMC(target, init_det(16, 3), 0.03, 5).seed(2)
        a.state = shard_sampler_state(mesh, a.state)  # 8-device run
        a.run(20, 0)
        save_sampler(_ckpt_path(tmp), a)  # gathered at save time
        cont_sharded = a.run(20, 0)

        # restore onto one device (no mesh): restored state is identical
        b = HMC(target, init_det(16, 3), 0.03, 5).seed(0)
        restore_sampler(_ckpt_path(tmp), b)
        assert len({s.device for s in b.state.positions.addressable_shards}) == 1
        saved_positions = np.asarray(b.state.positions)
        cont_single = b.run(20, 0)
        assert np.all(np.isfinite(np.asarray(cont_single)))

        # restore re-sharded over the 8-device mesh: same restored state,
        # and the continuation is BIT-EXACT vs the original sharded run
        # (same layout, same program, same key). Cross-layout continuations
        # are only statistically equivalent — XLA fuses differently per
        # partitioning (see test_parallel.test_sharded_hmc_matches_unsharded).
        c = HMC(target, init_det(16, 3), 0.03, 5).seed(0)
        restore_sampler(_ckpt_path(tmp), c, mesh=mesh)
        devs = {s.device for s in c.state.positions.addressable_shards}
        assert len(devs) == 8
        np.testing.assert_array_equal(
            np.asarray(c.state.positions), saved_positions
        )
        cont_resharded = c.run(20, 0)

    np.testing.assert_array_equal(
        np.asarray(cont_resharded), np.asarray(cont_sharded)
    )


def test_nuts_checkpoint_preserves_adaptation():
    # Dual-averaging state (epsilon, h_bar, m) survives the round-trip so a
    # resumed run continues identically.
    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    with tempfile.TemporaryDirectory() as tmp:
        a = NUTS(target, init_det(2, 2), 0.8).seed(5)
        a.run(10, 10)
        save_sampler(_ckpt_path(tmp), a)
        cont_a = a.run(15, 0)

        b = NUTS(target, init_det(2, 2), 0.8).seed(31337)
        restore_sampler(_ckpt_path(tmp), b)
        cont_b = b.run(15, 0)
    np.testing.assert_array_equal(np.asarray(cont_a), np.asarray(cont_b))


def test_metric_sampler_checkpoint_roundtrip_and_mismatch_guard():
    # A metric sampler's state lives in whitened coordinates; the saved
    # metric must travel with the checkpoint, restore bit-exactly into a
    # same-metric sampler, and REJECT a different-coordinate restore
    # (which would silently mis-scale every position).
    import jax.numpy as jnp

    from mini_mcmc_tpu.models.precondition import Preconditioner

    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    pre = Preconditioner(
        kind="dense", chol=jnp.linalg.cholesky(jnp.asarray(
            [[4.0, 2.0], [2.0, 3.0]]))
    )
    with tempfile.TemporaryDirectory() as tmp:
        a = HMC(target, init_det(4, 2), 0.9, 8, metric=pre).seed(5)
        a.run(10, 10)
        save_sampler(_ckpt_path(tmp), a)
        cont_a = a.run(15, 0)

        b = HMC(target, init_det(4, 2), 0.9, 8, metric=pre).seed(6)
        restore_sampler(_ckpt_path(tmp), b)
        cont_b = b.run(15, 0)
        np.testing.assert_array_equal(np.asarray(cont_a), np.asarray(cont_b))

        # no metric on the restoring sampler -> rejected
        plain = HMC(target, init_det(4, 2), 0.9, 8).seed(7)
        with pytest.raises(ValueError, match="metric"):
            restore_sampler(_ckpt_path(tmp), plain)
        # different metric -> rejected
        other = HMC(target, init_det(4, 2), 0.9, 8,
                    metric=Preconditioner(
                        kind="diag", scale=jnp.asarray([2.0, 1.7]))).seed(8)
        with pytest.raises(ValueError, match="metric"):
            restore_sampler(_ckpt_path(tmp), other)
        # and the reverse: unmetriced checkpoint into a metric sampler
        save_sampler(_ckpt_path(tmp) + "2", plain)
        with pytest.raises(ValueError, match="metric"):
            restore_sampler(_ckpt_path(tmp) + "2", a)


def test_nuts_checkpoint_missing_leapfrogs_leaf_migrates(tmp_path):
    """ADVICE r4: checkpoints written before NUTSState grew `leapfrogs`
    unflatten via the field's None default; restore_sampler must fill the
    missing leaf with the -1 'unknown history' sentinel instead of
    failing the structural tree_map with an opaque mismatch."""
    from mini_mcmc_tpu import NUTS
    from mini_mcmc_tpu.checkpoint import restore_sampler, save_checkpoint
    from mini_mcmc_tpu.models import diffable_gaussian2d

    target = diffable_gaussian2d([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    s = NUTS(target, init_det(4, 2), 0.8).seed(1)
    s.run(5, 2)
    # simulate the pre-field checkpoint: the leaf absent from the pytree
    old_state = s.state._replace(leapfrogs=None)
    path = str(tmp_path / "old_nuts")
    save_checkpoint(path, old_state, s._key)

    fresh = NUTS(target, init_det(4, 2), 0.8).seed(9)
    restore_sampler(path, fresh)
    assert np.all(np.asarray(fresh.state.leapfrogs) == -1)
    np.testing.assert_allclose(np.asarray(fresh.positions),
                               np.asarray(s.positions))
    # the sentinel persists through further runs (unknown history stays
    # unknown) and the sampler still works
    sample = fresh.run(3, 0)
    assert sample.shape == (4, 3, 2)
    assert np.all(np.asarray(fresh.leapfrogs) == -1)
    assert np.all(np.asarray(fresh.last_run_leapfrogs) == -1)
