"""Batched coordinate-wise slice sampler (Neal 2003).

Beyond-reference capability (the Rust reference at /root/reference has no
slice sampler): the classic gradient-free, self-tuning univariate slice
sampler with stepping-out and shrinkage (Neal 2003, Fig. 3/5), swept over
coordinates like the Gibbs kernel (/root/reference/src/gibbs.rs:95-99) so
it drops in anywhere ``GibbsSampler`` does but needs only ``target.logp``
— no full conditionals, no proposal tuning.

Batched design: the reference framework parallelizes chains by threads;
here all chains advance in lockstep ``[n_chains, D]`` batches, and the two
data-dependent phases of the algorithm become masked ``lax.while_loop``s
over the whole batch (the same lanes-with-masks treatment that makes the
per-chain-recursive NUTS lockstep in ``ops/nuts.py``):

- **stepping out** expands every chain's bracket together, each lane
  stopping when its own edges leave the slice (or its randomized budget is
  spent); the loop exits when every lane has stopped. Both edges are
  evaluated in one fused target call per iteration (vmapped over a new
  leading axis — never concatenated along the chain axis, which would
  break chain sharding).
- **shrinkage** draws candidates for all unconverged lanes together,
  accepting per-lane with ``where`` selects; geometric interval shrinkage
  guarantees quick convergence, and a generous iteration cap bounds the
  compiled loop (capped lanes keep their current state — an identity
  update, which preserves the stationary distribution).

Correctness notes:

- The stepping-out budget follows Neal's capped procedure: a single
  uniform budget of ``max_stepouts - 1`` total expansions is split
  randomly between the two edges (J left, m-1-J right), which keeps the
  bracket construction reversible even when the cap binds.
- Slice membership uses the strict test ``log y < logp(x')`` with
  ``log y = logp(x) + log U``, so ``-inf`` log densities (hard support
  constraints) are handled exactly: points outside the support are never
  accepted and never expand the bracket. Chains must START inside the
  support (logp > -inf), same as every other sampler here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.base import Target
from ..runner import make_scan_block_fn


class SliceState(NamedTuple):
    positions: jax.Array  # [C, D]
    logp: jax.Array  # [C] cached unnormalized target log density


def slice_kernel(target: Target, *, width=1.0, max_stepouts: int = 8,
                 max_shrink: int = 32, steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for the batched coordinate slice sweep.

    ``init_fn(positions [C, D]) -> SliceState``
    ``step_fn(state, key) -> SliceState``   (one full coordinate sweep)

    Args:
        target: only ``logp`` is required (gradient-free).
        width: initial bracket width ``w`` — a scalar or a per-coordinate
            ``[D]`` array. Slice sampling self-tunes: too-small widths cost
            stepping-out iterations, too-large widths cost shrinkage
            iterations, but the stationary distribution is exact either
            way (Neal 2003 §4).
        max_stepouts: the bracket grows by at most ``max_stepouts - 1``
            widths in total (randomly split between the two edges, which
            preserves reversibility under the cap — Neal 2003, Fig. 3).
        max_shrink: bound on shrinkage iterations; the interval shrinks
            geometrically, so 32 iterations resolve the accept region to
            ``~w * 2^-32`` and the cap binds only under float pathologies
            (a capped lane keeps its current coordinate — an identity
            update, still invariant).
        steps_per_call: > 1 attaches a K-sweep block function
            (``step_fn.block_fn``/``block_size``), same contract as the
            MH/HMC/Gibbs block kernels.
    """
    if max_stepouts < 1:
        raise ValueError(f"max_stepouts must be >= 1, got {max_stepouts}")
    if max_shrink < 1:
        raise ValueError(f"max_shrink must be >= 1, got {max_shrink}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    width = jnp.asarray(width)
    if width.ndim > 1:
        raise ValueError(
            f"width must be a scalar or [D] array, got shape {width.shape}"
        )
    if not bool(jnp.all(width > 0.0)):
        raise ValueError("width must be positive")

    def init_fn(positions: jax.Array) -> SliceState:
        positions = jnp.asarray(positions)
        return SliceState(
            positions=positions, logp=target.batch_logp(positions)
        )

    def _update_coordinate(positions, logp, i, key, w_all):
        """One slice update of coordinate ``i`` for every chain at once."""
        n_chains = positions.shape[0]
        dtype = positions.dtype
        k_y, k_u, k_j, k_shrink = jax.random.split(key, 4)
        x = positions[:, i]
        w = w_all[i]

        def f(values):
            """Target logp with coordinate ``i`` set per-chain -> [C]."""
            return target.batch_logp(positions.at[:, i].set(values))

        def f_edges(lv, rv):
            """Both bracket edges in one fused call: vmap over a NEW
            leading axis (never concatenate along the chain axis — that
            would force an all-gather when chains are sharded over a
            mesh; tests/test_parallel.py pins scalar-reduce-only)."""
            both = jax.vmap(f)(jnp.stack([lv, rv]))
            return both[0], both[1]

        # Slice height: log y = logp(x) + log U, U ~ Uniform(0, 1).
        logy = logp + jnp.log(
            jax.random.uniform(k_y, (n_chains,), dtype)
        )

        # Initial bracket of width w placed uniformly around x, with
        # Neal's randomized expansion budget split (J left, m-1-J right).
        u0 = jax.random.uniform(k_u, (n_chains,), dtype)
        left = x - w * u0
        right = left + w
        j_budget = jax.random.randint(k_j, (n_chains,), 0, max_stepouts)
        k_budget = (max_stepouts - 1) - j_budget

        # -- stepping out: expand both edges in lockstep -------------------
        def grow_flags(jb, kb, f_left, f_right):
            return (jb > 0) & (logy < f_left), (kb > 0) & (logy < f_right)

        fl0, fr0 = f_edges(left, right)
        carry0 = (left, right, j_budget, k_budget, fl0, fr0)

        def out_cond(carry):
            _, _, jb, kb, fl, fr = carry
            gl, gr = grow_flags(jb, kb, fl, fr)
            return jnp.any(gl | gr)

        def out_body(carry):
            lv, rv, jb, kb, fl, fr = carry
            gl, gr = grow_flags(jb, kb, fl, fr)
            lv = jnp.where(gl, lv - w, lv)
            rv = jnp.where(gr, rv + w, rv)
            jb = jb - gl.astype(jb.dtype)
            kb = kb - gr.astype(kb.dtype)
            fl_new, fr_new = f_edges(lv, rv)
            # Lanes that did not move keep their cached edge values (the
            # recomputed value is identical; where avoids relying on that
            # for -inf edge cases).
            fl = jnp.where(gl, fl_new, fl)
            fr = jnp.where(gr, fr_new, fr)
            return lv, rv, jb, kb, fl, fr

        left, right, _, _, _, _ = lax.while_loop(out_cond, out_body, carry0)

        # -- shrinkage: sample within the bracket, shrink on rejection -----
        def shr_cond(carry):
            _, _, _, _, done, it, _ = carry
            return jnp.any(~done) & (it < max_shrink)

        def shr_body(carry):
            lv, rv, x_new, lp_new, done, it, k = carry
            k, sub = jax.random.split(k)
            u = jax.random.uniform(sub, (n_chains,), dtype)
            cand = lv + u * (rv - lv)
            f_cand = f(cand)
            accept = ~done & (logy < f_cand)
            x_new = jnp.where(accept, cand, x_new)
            lp_new = jnp.where(accept, f_cand, lp_new)
            done = done | accept
            shrink_l = ~done & (cand < x)
            shrink_r = ~done & ~(cand < x)
            lv = jnp.where(shrink_l, cand, lv)
            rv = jnp.where(shrink_r, cand, rv)
            return lv, rv, x_new, lp_new, done, it + 1, k

        init_done = jnp.zeros((n_chains,), bool)
        _, _, x_new, lp_new, _, _, _ = lax.while_loop(
            shr_cond, shr_body,
            (left, right, x, logp, init_done, jnp.int32(0), k_shrink),
        )
        return positions.at[:, i].set(x_new), lp_new

    def step_fn(state: SliceState, key: jax.Array) -> SliceState:
        dim = state.positions.shape[1]
        w_all = jnp.broadcast_to(
            width.astype(state.positions.dtype), (dim,)
        )
        coord_keys = jax.random.split(key, dim)

        def body(i, carry):
            positions, logp = carry
            return _update_coordinate(positions, logp, i, coord_keys[i],
                                      w_all)

        positions, logp = lax.fori_loop(
            0, dim, body, (state.positions, state.logp)
        )
        return SliceState(positions=positions, logp=logp)

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
