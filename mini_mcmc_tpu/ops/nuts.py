"""No-U-Turn Sampler step kernel (iterative, lockstep-batched).

Batched redesign of the reference's recursive NUTS
(/root/reference/src/nuts.rs:550-996, Hoffman & Gelman Algorithm 6 with
slice sampling and dual-averaging adaptation). The reference recursion is
data-dependent per chain and runs one chain per OS thread; that cannot map
to XLA. Here the recursion is replaced by an *iterative binary-counter tree
builder* that is exactly equivalent (see docs/design.md for the argument):

- ``build_tree(.., j)`` processes its 2^j leapfrog states chronologically;
  the recursion's bottom-up merges are the merges of a binary counter (after
  leaf ``i``, merge ``count_trailing_ones(i)`` times), so subtree boundaries,
  U-turn checks, slice counts ``n'``, divergence flags and the progressive
  proposal swaps (right subtree wins with probability ``n2 / max(n1+n2, 1)``,
  nuts.rs:910-915) happen in the same order with the same operands.
- Early termination (divergence / sub-U-turn) freezes a chain's accumulators
  exactly where the recursion stops expanding; the partially built tree's
  remaining unequal-size merges only affect fields that are unused when
  ``s = false`` (boundaries, proposal), so they are skipped.

Batching design (the part that makes this fast on an accelerator):

- The whole step is hand-batched over chains — **no vmap**. ``vmap`` of
  nested ``while_loop``s inserts a ``select`` over *every* carry for *every*
  iteration (O(C * max_depth * D) stack traffic per leapfrog); the manual
  formulation masks only what semantics require (per-chain accumulators),
  letting diverged chains ride along as unmasked garbage lanes whose outputs
  are ignored.
- The binary-counter control state (leaf index, stack pointer, merge
  counts) depends only on the lockstep leaf index, so it is **scalar**, and
  the tree stack is one fused ``[max_depth+1, C, 4D+2]`` buffer addressed
  with scalar dynamic slices — one contiguous update per leaf, one gather
  per merge, no scatters.
- Per-merge uniforms come from one ``fold_in``-derived key per merge event
  (a single [C] draw), not per-chain key splits.

Deviation from the reference: the reference has *no* tree-depth cap
(nuts.rs:578-674); a fixed ``max_depth`` (default 10, Stan's default) is
required for bounded lockstep execution.

Dual averaging uses the reference constants gamma=0.05, t_0=10, kappa=0.75,
mu=ln(10*eps), epsilon_bar=1, h_bar=0 (nuts.rs:425-430) and the lazy
``find_reasonable_epsilon`` initialization (nuts.rs:540-543, :694-761).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.base import Target

# Dual-averaging constants (nuts.rs:425-430)
GAMMA = 0.05
T_0 = 10.0
KAPPA = 0.75
#: divergence threshold: s' = (logu - 1000) < joint (nuts.rs:807)
DIVERGENCE_DELTA = 1000.0
#: safety cap for find_reasonable_epsilon loops (reference is uncapped)
_FIND_EPS_MAX_ITERS = 100
#: saturation ceiling for the int32 cumulative leapfrog counter: leaves
#: 2^27 headroom so one more increment (any depth_limit <= 27) cannot wrap
#: negative. A saturated counter stays live and monotone instead of
#: silently flipping to the -1 'unavailable' sentinel (ADVICE r4).
_LEAPFROG_SAT = 2**31 - 2**27


class NUTSState(NamedTuple):
    """Batched NUTS chain state (leaves have leading chains axis)."""

    positions: jax.Array  # [C, D]
    epsilon: jax.Array  # [C] current step size (-1.0 sentinel = auto)
    epsilon_bar: jax.Array  # [C] averaged step size
    h_bar: jax.Array  # [C] dual-averaging error statistic
    mu: jax.Array  # [C] ln(10 * epsilon_0)
    m: jax.Array  # [C] int32 cumulative step count
    n_discard: jax.Array  # [C] int32 adaptation horizon of the current run
    divergences: jax.Array  # [C] int32 count of divergent transitions
    #: [C] int32 cumulative leapfrogs EXECUTED per chain lane (2^J - 1 per
    #: step for a J-deep doubling loop) — the lockstep COST including
    #: masked-lane waste, not per-chain useful work; one gradient eval per
    #: leapfrog (the per-step initial grad and the epsilon search are not
    #: included). Saturates at ``_LEAPFROG_SAT`` (~2.0e9) instead of
    #: wrapping int32; -1 only for states restored from checkpoints that
    #: predate the counter.
    #: The ``None`` default exists ONLY so checkpoints written before this
    #: field was added still unflatten (their pickled treedef constructs
    #: the state with one fewer leaf); ``restore_sampler`` fills the
    #: missing leaf with the -1 'unknown history' sentinel. Every kernel
    #: constructs it explicitly.
    leapfrogs: jax.Array = None


def _leapfrog1(target: Target, pos, mom, grad, eps):
    """Single leapfrog step on one chain (nuts.rs:979-996)."""
    mom = mom + grad * (eps * 0.5)
    pos = pos + mom * eps
    logp, grad = target.logp_and_grad(pos)
    mom = mom + grad * (eps * 0.5)
    return pos, mom, grad, logp


def _leapfrog_batch(target: Target, pos, mom, grad, eps):
    """Batched leapfrog: pos/mom/grad ``[C, D]``, eps ``[C]``."""
    e = eps[:, None]
    mom = mom + grad * (e * 0.5)
    pos = pos + mom * e
    logp, grad = target.batch_logp_and_grad(pos)
    mom = mom + grad * (e * 0.5)
    return pos, mom, grad, logp


def _all_real(x) -> jax.Array:
    """True iff no NaN/Inf anywhere (nuts.rs:948-961)."""
    return jnp.logical_not(jnp.any(jnp.isinf(x) | jnp.isnan(x)))


def find_reasonable_epsilon(target: Target, position, mom):
    """Step-size heuristic (nuts.rs:694-761), per chain.

    Halve a trial multiplier until the first leapfrog is finite, set
    ``eps = 0.5 * k``, then double (or halve) until the acceptance
    probability crosses 1/2. Faithful to the reference's quirks: the
    finiteness loop requires both logp *and* grad non-real to continue
    (``&&`` of two negations, nuts.rs:717), and the result is
    ``0.5 * k * eps`` even when the loop never runs (so the search starts at
    0.5).
    """
    dtype = position.dtype
    one = jnp.asarray(1.0, dtype)
    logp0, grad0 = target.logp_and_grad(position)
    ke0 = 0.5 * jnp.sum(mom * mom)

    def lf(eps):
        _, mom_p, grad_p, logp_p = _leapfrog1(target, position, mom, grad0, eps)
        return mom_p, grad_p, logp_p

    mom_p, grad_p, logp_p = lf(one)

    def halve_cond(carry):
        k, mom_p, grad_p, logp_p, it = carry
        bad = jnp.logical_not(_all_real(logp_p)) & jnp.logical_not(
            _all_real(grad_p)
        )
        return bad & (it < _FIND_EPS_MAX_ITERS)

    def halve_body(carry):
        k, mom_p, grad_p, logp_p, it = carry
        k = k * 0.5
        mom_p, grad_p, logp_p = lf(k)  # epsilon * k with epsilon == 1
        return k, mom_p, grad_p, logp_p, it + 1

    k, mom_p, grad_p, logp_p, _ = lax.while_loop(
        halve_cond, halve_body, (one, mom_p, grad_p, logp_p, jnp.int32(0))
    )

    epsilon = 0.5 * k
    log_accept = logp_p - logp0 - (0.5 * jnp.sum(mom_p * mom_p) - ke0)
    ln2 = jnp.asarray(jnp.log(2.0), dtype)
    a = jnp.where(log_accept > -ln2, one, -one)  # ln(0.5) = -ln2

    def dbl_cond(carry):
        epsilon, log_accept, it = carry
        return (a * log_accept > -a * ln2) & (it < _FIND_EPS_MAX_ITERS)

    def dbl_body(carry):
        epsilon, log_accept, it = carry
        epsilon = epsilon * jnp.power(jnp.asarray(2.0, dtype), a)
        mom_p, _, logp_p = lf(epsilon)
        log_accept = logp_p - logp0 - (0.5 * jnp.sum(mom_p * mom_p) - ke0)
        return epsilon, log_accept, it + 1

    epsilon, _, _ = lax.while_loop(
        dbl_cond, dbl_body, (epsilon, log_accept, jnp.int32(0))
    )
    return epsilon


def find_reasonable_epsilon_batch(target: Target, positions, mom):
    """Hand-batched ``find_reasonable_epsilon``: positions/mom ``[C, D]`` ->
    epsilon ``[C]``.

    Same per-chain semantics as the scalar version (which stays as the
    test oracle), but with ONE masked ``while_loop`` over batched tensors:
    each iteration is a single ``[C, D]`` leapfrog (one batched
    logp-and-grad) instead of vmapping a per-chain nested
    ``while_loop`` — the batched-while select over every per-chain carry
    the module docstring's tree builder was hand-batched to avoid. Chains
    freeze (``where`` on an active mask) once their own exit condition
    holds; the active set only shrinks, so per-chain iteration counts (and
    the safety-cap semantics) match the scalar loop.
    """
    dtype = positions.dtype
    c = positions.shape[0]
    one = jnp.ones((c,), dtype)
    ln2 = jnp.asarray(jnp.log(2.0), dtype)
    logp0, grad0 = target.batch_logp_and_grad(positions)
    ke0 = 0.5 * jnp.sum(mom * mom, axis=-1)

    def lf(eps):
        _, mom_p, grad_p, logp_p = _leapfrog_batch(
            target, positions, mom, grad0, eps
        )
        return mom_p, grad_p, logp_p

    def bad(logp_p, grad_p):
        # nuts.rs:717 quirk: continue only while logp AND grad are non-real.
        bad_logp = jnp.isnan(logp_p) | jnp.isinf(logp_p)
        bad_grad = jnp.any(jnp.isnan(grad_p) | jnp.isinf(grad_p), axis=-1)
        return bad_logp & bad_grad

    mom_p, grad_p, logp_p = lf(one)

    def halve_cond(carry):
        k, mom_p, grad_p, logp_p, it = carry
        return jnp.any(bad(logp_p, grad_p)) & (it < _FIND_EPS_MAX_ITERS)

    def halve_body(carry):
        k, mom_p, grad_p, logp_p, it = carry
        active = bad(logp_p, grad_p)
        k = jnp.where(active, k * 0.5, k)
        mom_n, grad_n, logp_n = lf(k)
        mom_p = jnp.where(active[:, None], mom_n, mom_p)
        grad_p = jnp.where(active[:, None], grad_n, grad_p)
        logp_p = jnp.where(active, logp_n, logp_p)
        return k, mom_p, grad_p, logp_p, it + 1

    k, mom_p, grad_p, logp_p, _ = lax.while_loop(
        halve_cond, halve_body, (one, mom_p, grad_p, logp_p, jnp.int32(0))
    )

    epsilon = 0.5 * k
    log_accept = logp_p - logp0 - (0.5 * jnp.sum(mom_p * mom_p, axis=-1) - ke0)
    a = jnp.where(log_accept > -ln2, one, -one)
    two_pow_a = jnp.power(jnp.asarray(2.0, dtype), a)

    def dbl_cond(carry):
        epsilon, log_accept, it = carry
        return jnp.any(a * log_accept > -a * ln2) & (it < _FIND_EPS_MAX_ITERS)

    def dbl_body(carry):
        epsilon, log_accept, it = carry
        active = a * log_accept > -a * ln2
        epsilon = jnp.where(active, epsilon * two_pow_a, epsilon)
        mom_p, _, logp_p = lf(epsilon)
        la = logp_p - logp0 - (0.5 * jnp.sum(mom_p * mom_p, axis=-1) - ke0)
        log_accept = jnp.where(active, la, log_accept)
        return epsilon, log_accept, it + 1

    epsilon, _, _ = lax.while_loop(
        dbl_cond, dbl_body, (epsilon, log_accept, jnp.int32(0))
    )
    return epsilon


def _count_trailing_ones(i):
    """Number of trailing 1-bits of ``i`` = ctz(i+1)."""
    x = i + 1
    return lax.population_count((x & -x) - 1)


class _TreeResult(NamedTuple):
    """Batched subtree result (all leaves carry a chains axis)."""

    end_pos: jax.Array  # [C, D] chronological last integration state
    end_mom: jax.Array  # [C, D]
    end_grad: jax.Array  # [C, D]
    prop_pos: jax.Array  # [C, D] selected proposal
    prop_grad: jax.Array  # [C, D]
    prop_logp: jax.Array  # [C]
    n: jax.Array  # [C] int32 slice-passing count
    s: jax.Array  # [C] bool: no divergence / no sub-U-turn
    alpha: jax.Array  # [C]
    n_alpha: jax.Array  # [C] int32
    diverged: jax.Array  # [C] bool: a leaf tripped the divergence check


def _build_subtree_batched(
    target: Target,
    max_depth: int,
    pos,  # [C, D] subtree start (chronological first is one leapfrog in)
    mom,  # [C, D]
    grad,  # [C, D]
    logu,  # [C]
    v,  # [C] int32 (+1 / -1)
    j,  # scalar int32: depth (2^j leaves), lockstep across chains
    epsilon,  # [C]
    joint_0,  # [C]
    active,  # [C] bool: chains whose accumulators may change
    key,  # scalar key; per-merge uniforms derive via fold_in
) -> _TreeResult:
    """Grow the 2^j-leaf subtree for all chains in lockstep.

    Equivalent to the recursion at nuts.rs:763-946 (see module docstring).
    Inactive chains ride along unmasked (their outputs are ignored by the
    caller); only accumulators and the divergence flag are masked.
    """
    dtype = pos.dtype
    c, dim = pos.shape
    m_rows = max_depth + 1
    # fused stack row: [first_pos | first_mom | prop_pos | prop_grad |
    #                   prop_logp | n]
    width = 4 * dim + 2
    fp, fm, pp, pg = (slice(0, dim), slice(dim, 2 * dim),
                      slice(2 * dim, 3 * dim), slice(3 * dim, 4 * dim))
    i_lp = 4 * dim
    i_n = 4 * dim + 1

    n_leaves = jnp.int32(1) << j
    eps_signed = epsilon * v.astype(dtype)

    def cond(carry):
        i = carry[0]
        s_any = carry[-1]
        return (i < n_leaves) & s_any

    def body(carry):
        (i, cur_pos, cur_mom, cur_grad, stack, s_run,
         n_tot, alpha_tot, n_alpha_tot, diverged, _s_any) = carry

        # --- leaf: one leapfrog for every chain (nuts.rs:795-830) --------
        cur_pos, cur_mom, cur_grad, logp = _leapfrog_batch(
            target, cur_pos, cur_mom, cur_grad, eps_signed
        )
        joint = logp - 0.5 * jnp.sum(cur_mom * cur_mom, axis=1)
        n_leaf = (logu < joint).astype(jnp.int32)
        s_leaf = (logu - DIVERGENCE_DELTA) < joint
        alpha_leaf = jnp.minimum(
            jnp.asarray(1.0, dtype), jnp.exp(joint - joint_0)
        )
        # NaN joint (inf kinetic energy on a wild excursion, e.g. during
        # early adaptation on a stiff target): the leaf is already a
        # divergence via the s_leaf comparison below, but a NaN alpha
        # would poison the dual-averaging h_bar and pin epsilon to NaN
        # FOREVER (one bad step freezes the chain). Count it as 0
        # acceptance, the ops/hmc.py convention.
        alpha_leaf = jnp.where(jnp.isnan(alpha_leaf), 0.0, alpha_leaf)

        live = active & s_run
        n_tot = n_tot + jnp.where(live, n_leaf, 0)
        alpha_tot = alpha_tot + jnp.where(live, alpha_leaf, 0.0)
        n_alpha_tot = n_alpha_tot + jnp.where(live, 1, 0)
        diverged = diverged | (live & jnp.logical_not(s_leaf))
        s_run = s_run & s_leaf

        # push the leaf row at the (scalar) binary-counter position
        row = jnp.concatenate(
            [cur_pos, cur_mom, cur_pos, cur_grad, logp[:, None],
             n_leaf.astype(dtype)[:, None]],
            axis=1,
        )
        sp = lax.population_count(i)  # stack height before this leaf
        zero = jnp.zeros((), sp.dtype)
        stack = lax.dynamic_update_slice(stack, row[None], (sp, zero, zero))

        # --- cascade merges: binary counter (nuts.rs:858-929) ------------
        n_merges = _count_trailing_ones(i)

        def merge_body(k_merge, mc):
            stack, s_run, top = mc
            # A at scalar row top-1 (top = current stack height - 1 is the
            # merged/right entry's row; after each merge height shrinks).
            ia = sp - 1 - k_merge  # scalar row index of left entry A
            z = jnp.zeros((), ia.dtype)
            a_row = lax.dynamic_slice(stack, (ia, z, z), (1, c, width))[0]
            b_row = top

            n_a = a_row[:, i_n]
            n_b = b_row[:, i_n]
            u = jax.random.uniform(
                jax.random.fold_in(key, i * (max_depth + 1) + k_merge),
                (c,), dtype,
            )
            take_b = u < n_b / jnp.maximum(n_a + n_b, 1.0)

            # U-turn between merged subtree's chronological boundaries:
            # first = A.first, last = current integration state.
            d_chrono = cur_pos - a_row[:, fp]
            vf = v.astype(dtype)
            ok = (
                vf * jnp.sum(d_chrono * a_row[:, fm], axis=1) >= 0
            ) & (vf * jnp.sum(d_chrono * cur_mom, axis=1) >= 0)

            merged = jnp.concatenate(
                [
                    a_row[:, fp],
                    a_row[:, fm],
                    jnp.where(take_b[:, None], b_row[:, pp], a_row[:, pp]),
                    jnp.where(take_b[:, None], b_row[:, pg], a_row[:, pg]),
                    jnp.where(take_b, b_row[:, i_lp], a_row[:, i_lp])[:, None],
                    (n_a + n_b)[:, None],
                ],
                axis=1,
            )
            stack = lax.dynamic_update_slice(stack, merged[None], (ia, z, z))
            s_run = s_run & ok
            return stack, s_run, merged

        top = row
        stack, s_run, top = lax.fori_loop(
            0, n_merges, merge_body, (stack, s_run, top)
        )

        s_any = jnp.any(active & s_run)
        return (i + 1, cur_pos, cur_mom, cur_grad, stack, s_run,
                n_tot, alpha_tot, n_alpha_tot, diverged, s_any)

    init = (
        jnp.int32(0),
        pos,
        mom,
        grad,
        jnp.zeros((m_rows, c, width), dtype),
        jnp.ones((c,), bool),
        jnp.zeros((c,), jnp.int32),
        jnp.zeros((c,), dtype),
        jnp.zeros((c,), jnp.int32),
        jnp.zeros((c,), bool),
        jnp.any(active),
    )
    (_i, cur_pos, cur_mom, cur_grad, stack, s_run,
     n_tot, alpha_tot, n_alpha_tot, diverged, _s_any) = lax.while_loop(
        cond, body, init)

    root = stack[0]
    return _TreeResult(
        end_pos=cur_pos,
        end_mom=cur_mom,
        end_grad=cur_grad,
        prop_pos=root[:, pp],
        prop_grad=root[:, pg],
        prop_logp=root[:, i_lp],
        n=n_tot,
        s=s_run,
        alpha=alpha_tot,
        n_alpha=n_alpha_tot,
        diverged=diverged,
    )


def _build_subtree(
    target: Target,
    max_depth: int,
    pos,
    mom,
    grad,
    logu,
    v,
    j,
    epsilon,
    joint_0,
    key,
):
    """Single-chain subtree builder (C = 1 view of the batched kernel);
    used by the golden parity tests against the reference's recorded
    ``build_tree`` values (nuts.rs:1057-1121)."""
    res = _build_subtree_batched(
        target,
        max_depth,
        pos[None],
        mom[None],
        grad[None],
        jnp.asarray(logu)[None],
        jnp.asarray(v, jnp.int32)[None],
        jnp.asarray(j, jnp.int32),
        jnp.asarray(epsilon, pos.dtype)[None],
        jnp.asarray(joint_0, pos.dtype)[None],
        jnp.ones((1,), bool),
        key,
    )
    return _TreeResult(*[x[0] for x in res])


def _depth_limit(state, m, max_depth, warmup_max_depth):
    """The step's runtime tree-depth cap — the SINGLE copy shared by the
    XLA doubling loop and the fused full-step kernel path.

    Lockstep execution waits for the deepest tree across all chains;
    during warm-up a few unequilibrated stragglers otherwise force
    max-depth trees every step. Capping depth during adaptation only
    bounds that wall-time cost (steady-state sampling is unaffected)."""
    if warmup_max_depth is not None and warmup_max_depth < max_depth:
        warming_now = m[0] <= state.n_discard[0]
        return jnp.where(
            warming_now, jnp.int32(warmup_max_depth), jnp.int32(max_depth)
        )
    return jnp.int32(max_depth)


def _nuts_step_batched(
    target: Target,
    target_accept_p: float,
    max_depth: int,
    state: "NUTSState",
    key: jax.Array,
    warmup_max_depth: int | None = None,
) -> "NUTSState":
    """One NUTS update for all chains in lockstep (nuts.rs:550-691)."""
    positions = state.positions
    dtype = positions.dtype
    c, dim = positions.shape
    one = jnp.asarray(1.0, dtype)
    key_mom, key_exp, key_dir, key_acc, key_tree = jax.random.split(key, 5)
    m = state.m + 1  # reference increments at step start (nuts.rs:551)

    mom_0 = jax.random.normal(key_mom, positions.shape, dtype)
    logp, grad = target.batch_logp_and_grad(positions)
    joint = logp - 0.5 * jnp.sum(mom_0 * mom_0, axis=1)
    logu = joint - jax.random.exponential(key_exp, (c,), dtype)

    depth_limit = _depth_limit(state, m, max_depth, warmup_max_depth)

    def cond(carry):
        j = carry[0]
        s = carry[9]
        return (j < depth_limit) & jnp.any(s)

    def body(carry):
        (j, pos_minus, mom_minus, grad_minus, pos_plus, mom_plus, grad_plus,
         position_sel, n, s, alpha, n_alpha, diverged) = carry

        v = jnp.where(
            jax.random.uniform(jax.random.fold_in(key_dir, j), (c,), dtype)
            < 0.5,
            jnp.int32(-1),
            jnp.int32(1),
        )
        neg = (v == -1)[:, None]
        start_pos = jnp.where(neg, pos_minus, pos_plus)
        start_mom = jnp.where(neg, mom_minus, mom_plus)
        start_grad = jnp.where(neg, grad_minus, grad_plus)

        res = _build_subtree_batched(
            target, max_depth, start_pos, start_mom, start_grad,
            logu, v, j, state.epsilon, joint, s,
            jax.random.fold_in(key_tree, j),
        )

        upd_minus = neg & s[:, None]
        upd_plus = (~neg) & s[:, None]
        pos_minus = jnp.where(upd_minus, res.end_pos, pos_minus)
        mom_minus = jnp.where(upd_minus, res.end_mom, mom_minus)
        grad_minus = jnp.where(upd_minus, res.end_grad, grad_minus)
        pos_plus = jnp.where(upd_plus, res.end_pos, pos_plus)
        mom_plus = jnp.where(upd_plus, res.end_mom, mom_plus)
        grad_plus = jnp.where(upd_plus, res.end_grad, grad_plus)

        # Progressive acceptance: u < min(1, n'/n) (nuts.rs:656-663).
        ratio = res.n.astype(dtype) / n.astype(dtype)
        u2 = jax.random.uniform(jax.random.fold_in(key_acc, j), (c,), dtype)
        take = s & res.s & (u2 < jnp.minimum(one, ratio))
        position_sel = jnp.where(take[:, None], res.prop_pos, position_sel)

        n = n + jnp.where(s, res.n, 0)
        d = pos_plus - pos_minus
        no_uturn = (jnp.sum(d * mom_minus, axis=1) >= 0) & (
            jnp.sum(d * mom_plus, axis=1) >= 0
        )
        alpha = jnp.where(s, res.alpha, alpha)
        n_alpha = jnp.where(s, res.n_alpha, n_alpha)
        diverged = diverged | (s & res.diverged)
        s = s & res.s & no_uturn
        return (j + 1, pos_minus, mom_minus, grad_minus,
                pos_plus, mom_plus, grad_plus,
                position_sel, n, s, alpha, n_alpha, diverged)

    init = (
        jnp.int32(0),
        positions, mom_0, grad,
        positions, mom_0, grad,
        positions,
        jnp.ones((c,), jnp.int32),
        jnp.ones((c,), bool),
        jnp.zeros((c,), dtype),
        jnp.zeros((c,), jnp.int32),
        jnp.zeros((c,), bool),
    )
    (_j, _pm, _mm, _gm, _pp, _mp, _gp, position_sel, _n, _s, alpha,
     n_alpha, diverged) = lax.while_loop(cond, body, init)

    # every lane executes the full lockstep doubling loop: 2^J - 1
    # leapfrogs (one gradient eval each), masked or not
    leapfrog_inc = (jnp.int32(1) << _j) - 1
    return _finish_step(
        state, target_accept_p, m, position_sel, alpha, n_alpha, diverged,
        leapfrog_inc=leapfrog_inc,
    )


def _finish_step(state, target_accept_p, m, position_sel, alpha, n_alpha,
                 diverged, leapfrog_inc):
    """Dual averaging + state assembly (nuts.rs:676-691).

    ``leapfrog_inc``: this step's executed-leapfrog count (int32 scalar
    from the doubling loop). The accumulate SATURATES at ``_LEAPFROG_SAT``
    instead of wrapping int32 (ADVICE r4: a depth-10 tree adds 1023/step, so
    ~2.1M steps would wrap negative and sticky-pin the -1 sentinel)."""
    dtype = position_sel.dtype
    one = jnp.asarray(1.0, dtype)
    mf = m.astype(dtype)
    eta = one / (mf + T_0)
    h_bar = (1.0 - eta) * state.h_bar + eta * (
        target_accept_p - alpha / jnp.maximum(n_alpha, 1).astype(dtype)
    )
    warming = m <= state.n_discard
    eps_warm = jnp.exp(state.mu - jnp.sqrt(mf) / GAMMA * h_bar)
    eta2 = jnp.power(mf, -KAPPA)
    eps_bar_warm = jnp.exp(
        (1.0 - eta2) * jnp.log(state.epsilon_bar) + eta2 * jnp.log(eps_warm)
    )
    epsilon = jnp.where(warming, eps_warm, state.epsilon_bar)
    epsilon_bar = jnp.where(warming, eps_bar_warm, state.epsilon_bar)

    sat = jnp.int32(_LEAPFROG_SAT)
    # below sat the add cannot overflow (headroom >= any increment);
    # at/above sat the add may wrap, but the outer where discards it
    bumped = jnp.where(
        state.leapfrogs >= sat, sat,
        jnp.minimum(state.leapfrogs + leapfrog_inc, sat),
    )
    leapfrogs = jnp.where(state.leapfrogs >= 0, bumped, state.leapfrogs)
    return NUTSState(
        positions=position_sel,
        epsilon=epsilon,
        epsilon_bar=epsilon_bar,
        h_bar=h_bar,
        mu=state.mu,
        m=m,
        n_discard=state.n_discard,
        divergences=state.divergences + diverged.astype(jnp.int32),
        leapfrogs=leapfrogs,
    )


def nuts_kernel(target: Target, target_accept_p: float, max_depth: int = 10,
                warmup_max_depth: int | None = None):
    """Build ``(init_fn, prepare_fn, step_fn)`` for batched NUTS.

    ``init_fn(positions [C, D]) -> NUTSState`` (epsilon sentinel = -1,
    matching nuts.rs:415-433).
    ``prepare_fn(state, key, n_discard) -> NUTSState`` runs
    ``find_reasonable_epsilon`` for sentinel chains and resets
    ``mu = ln(10 * eps)`` (init_chain, nuts.rs:528-545).
    ``step_fn(state, key) -> NUTSState``.
    """

    def init_fn(positions: jax.Array) -> NUTSState:
        positions = jnp.asarray(positions)
        c = positions.shape[0]
        dtype = positions.dtype
        return NUTSState(
            positions=positions,
            epsilon=jnp.full((c,), -1.0, dtype),
            epsilon_bar=jnp.ones((c,), dtype),
            h_bar=jnp.zeros((c,), dtype),
            mu=jnp.full((c,), jnp.log(10.0), dtype),
            m=jnp.zeros((c,), jnp.int32),
            n_discard=jnp.zeros((c,), jnp.int32),
            divergences=jnp.zeros((c,), jnp.int32),
            leapfrogs=jnp.zeros((c,), jnp.int32),
        )

    def prepare_fn(state: NUTSState, key: jax.Array, n_discard: int) -> NUTSState:
        c = state.positions.shape[0]
        dtype = state.positions.dtype
        mom_0 = jax.random.normal(key, state.positions.shape, dtype)
        sentinel = jnp.abs(state.epsilon + 1.0) <= jnp.finfo(dtype).eps

        def search(_):
            return find_reasonable_epsilon_batch(
                target, state.positions, mom_0
            )

        # The epsilon search only runs when some chain still carries the
        # -1 sentinel (first run); continuation runs skip it, like the
        # reference's guard (nuts.rs:540-543) — only mu is refreshed.
        eps_found = lax.cond(
            jnp.any(sentinel), search, lambda _: state.epsilon, None
        )
        epsilon = jnp.where(sentinel, eps_found, state.epsilon)
        mu = jnp.log(10.0 * epsilon)
        return state._replace(
            epsilon=epsilon,
            mu=mu,
            n_discard=jnp.full((c,), n_discard, jnp.int32),
        )

    def step_fn(state: NUTSState, key: jax.Array) -> NUTSState:
        return _nuts_step_batched(
            target, target_accept_p, max_depth, state, key,
            warmup_max_depth=warmup_max_depth,
        )

    return init_fn, prepare_fn, step_fn
