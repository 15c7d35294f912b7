"""ChEES-HMC: gradient-based trajectory-length adaptation (beyond reference).

Hoffman, Radul & Sountsov, "An Adaptive-MCMC Scheme for Setting Trajectory
Lengths in Hamiltonian Monte Carlo" (AISTATS 2021). The reference library
never adapts the HMC trajectory length (``n_leapfrog`` is fixed forever,
/root/reference/src/hmc.rs:87-109); NUTS adapts it implicitly but pays for
per-chain dynamic trees. ChEES is the lockstep alternative built for
EXACTLY this framework's regime — thousands of chains advancing together on
an accelerator: it maximizes the Change in the Estimator of the Expected
Square of the centered squared norm,

    ChEES(T) = 1/4 * E[ (||x' - E x'||^2 - ||x - E x||^2)^2 ],

whose gradient with respect to the integration time is available in closed
form from quantities every HMC step already computes (the proposal endpoint
and its final velocity: d x'/dt = v'), with the expectation estimated
ACROSS CHAINS. More chains = a better gradient estimate, so the method gets
stronger exactly where this framework lives. Per iteration all chains share
one jittered integration time ``t_m = u_m * T`` (``u_m`` from a base-2
Halton sequence), so the whole batch stays in lockstep: the only
data-dependent quantity is the SCALAR leapfrog count, a
``lax.while_loop`` trip count — no per-chain divergence, unlike NUTS trees.

Shape: the entire warmup is ONE ``lax.scan`` over adaptation steps; the
cross-chain reductions (two means, two weighted sums) are the only
collectives when chains are sharded over a mesh, and they vanish after
warmup — the production kernel (:func:`chees_hmc_kernel`) samples with zero
communication like every other kernel in ``ops/``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.base import Target
from .hmc import HMCState
from .nuts import GAMMA, KAPPA, T_0


def halton_u(m: jax.Array) -> jax.Array:
    """Base-2 radical inverse (van der Corput / first Halton dimension) of
    integer ``m >= 1`` -> float in (0, 1): bit-reverse the 32-bit index and
    scale by 2^-32. Quasi-random jitter spreads trajectory lengths far more
    evenly than iid uniforms at small sample counts, which both
    de-resonates the fixed-length integrator and lowers the variance of
    the ChEES gradient estimate (Hoffman et al. 2021, section 3)."""
    def u32(x):
        return jnp.uint32(x)

    b = jnp.asarray(m, jnp.uint32)
    b = ((b & u32(0x55555555)) << 1) | ((b & u32(0xAAAAAAAA)) >> 1)
    b = ((b & u32(0x33333333)) << 2) | ((b & u32(0xCCCCCCCC)) >> 2)
    b = ((b & u32(0x0F0F0F0F)) << 4) | ((b & u32(0xF0F0F0F0)) >> 4)
    b = ((b & u32(0x00FF00FF)) << 8) | ((b & u32(0xFF00FF00)) >> 8)
    b = (b << 16) | (b >> 16)
    return b.astype(jnp.result_type(float)) * jnp.asarray(
        2.0**-32, jnp.result_type(float)
    )


def _dynamic_leapfrog(target: Target, pos, mom, logp, grad, eps, n_steps):
    """``n_steps`` (a traced SCALAR) leapfrog steps with the cached
    half-step-gradient recurrence (one gradient evaluation per step, the
    ops/hmc.py pattern; hmc.rs:397-431). A ``lax.while_loop`` because the
    trip count is data-dependent — all chains still advance in lockstep,
    the loop bound is shared."""
    half_eps = eps * 0.5

    def cond(carry):
        return carry[0] < n_steps

    def body(carry):
        i, pos, mom, _, grad = carry
        mom = mom + grad * half_eps
        pos = pos + eps * mom
        logp, grad = target.batch_logp_and_grad(pos)
        mom = mom + grad * half_eps
        return (i + 1, pos, mom, logp, grad)

    _, pos, mom, logp, grad = lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), pos, mom, logp, grad)
    )
    return pos, mom, logp, grad


def _jittered_step(target: Target, state: HMCState, key, eps, traj_len, u,
                   max_leapfrog: int):
    """One jittered-trajectory HMC step shared by the warmup and the
    production kernel. Integration time ``t = u * traj_len``; leapfrog
    count ``L = clip(ceil(t / eps), 1, max_leapfrog)``. Returns the updated
    state plus everything the ChEES gradient needs (proposal endpoint,
    final velocity, per-chain acceptance probability)."""
    dtype = state.positions.dtype
    eps = jnp.asarray(eps, dtype)
    t = u * traj_len
    n_steps = jnp.clip(
        jnp.ceil(t / eps).astype(jnp.int32), 1, max_leapfrog
    )
    key_mom, key_u = jax.random.split(key)
    mom0 = jax.random.normal(key_mom, state.positions.shape, dtype)
    h_current = -state.logp + 0.5 * jnp.sum(mom0 * mom0, axis=1)
    pos_prop, mom_prop, logp_prop, grad_prop = _dynamic_leapfrog(
        target, state.positions, mom0, state.logp, state.grad, eps, n_steps
    )
    h_proposed = -logp_prop + 0.5 * jnp.sum(mom_prop * mom_prop, axis=1)
    accept_logp = h_current - h_proposed
    alpha_c = jnp.exp(jnp.minimum(accept_logp, 0.0))
    alpha_c = jnp.where(jnp.isnan(alpha_c), 0.0, alpha_c)
    n_chains = state.positions.shape[0]
    uacc = jax.random.uniform(key_u, (n_chains,), accept_logp.dtype)
    accept = accept_logp >= jnp.log(uacc)  # NaN compares False
    new_state = HMCState(
        positions=jnp.where(accept[:, None], pos_prop, state.positions),
        logp=jnp.where(accept, logp_prop, state.logp),
        grad=jnp.where(accept[:, None], grad_prop, state.grad),
    )
    return new_state, pos_prop, mom_prop, alpha_c


def _chees_grad_logT(positions, pos_prop, mom_prop, alpha_c, t):
    """Acceptance-weighted estimate of d ChEES / d log(traj_len).

    Per chain, with centered endpoints ``xc = x - mean(x)`` and
    ``xc' = x' - mean(x')``:

        d/dt [ 1/4 (||xc'||^2 - ||xc||^2)^2 ]
            = (||xc'||^2 - ||xc||^2) * (xc' . v'),

    since d x'/dt is the final velocity ``v' = mom_prop`` (unit mass).
    Chains are weighted by their acceptance probability (a rejected
    endpoint carries no information about good trajectory lengths), and
    the chain rule through ``t = u * T`` contributes ``dt/dlogT = t``.
    Non-finite contributions (divergent trajectories) are dropped; if every
    chain diverged the gradient is 0 (no update)."""
    xc = positions - jnp.mean(positions, axis=0, keepdims=True)
    xpc = pos_prop - jnp.mean(pos_prop, axis=0, keepdims=True)
    d = jnp.sum(xpc * xpc, axis=1) - jnp.sum(xc * xc, axis=1)
    g_i = d * jnp.sum(xpc * mom_prop, axis=1)
    ok = jnp.isfinite(g_i)
    w = jnp.where(ok, alpha_c, 0.0)
    wsum = jnp.sum(w)
    g = jnp.where(
        wsum > 0.0,
        jnp.sum(w * jnp.where(ok, g_i, 0.0)) / jnp.maximum(wsum, 1e-12),
        0.0,
    )
    return g * t


class _CheesCarry(NamedTuple):
    state: HMCState
    log_eps: jax.Array
    log_eps_bar: jax.Array
    h_bar: jax.Array
    log_T: jax.Array
    log_T_bar: jax.Array
    adam_m: jax.Array
    adam_v: jax.Array


def chees_adapt(
    target: Target,
    state: HMCState,
    key: jax.Array,
    n_adapt: int,
    eps0: float,
    traj_len0: float | None = None,
    target_accept: float = 0.651,
    adam_lr: float = 0.025,
    max_leapfrog: int = 1024,
):
    """Jointly adapt the step size (dual averaging, the reference's NUTS
    constants — ops/adapt.py's update) and the trajectory length (Adam
    ascent on the ChEES criterion) over ``n_adapt`` jittered HMC steps.

    ``state`` is an ``ops/hmc.py`` ``HMCState`` (cached logp/grad);
    ``traj_len0`` defaults to ``eps0`` (one leapfrog — the adaptation grows
    it, Hoffman et al. 2021 section 4). ``adam_lr`` is the paper's 0.025
    on ``log T``; the returned trajectory length is the ``m^-kappa``
    iterate average of ``log T`` (the same averaging the step size gets),
    clamped to ``[eps, max_leapfrog * eps]`` throughout so the leapfrog
    count stays in budget.

    Returns ``(state, eps, traj_len, trace)`` with
    ``trace = {"alpha": [n_adapt], "traj_len": [n_adapt], "eps": [n_adapt]}``.
    ``eps``/``traj_len`` are scalar jax arrays (not Python floats), so the
    whole adaptation is jittable/lowerable — e.g. for the sharded-warmup
    collective proofs in tests/test_parallel.py; cast with ``float()``
    before baking them into kernel closures (``ChEESHMC.warmed_up`` does).
    """
    if n_adapt < 1:
        raise ValueError(f"n_adapt must be >= 1, got {n_adapt}")
    if traj_len0 is None:
        traj_len0 = eps0
    dt = jnp.result_type(float)
    mu = jnp.log(jnp.asarray(10.0 * eps0, dt))
    beta1, beta2, adam_eps = 0.9, 0.999, 1e-8

    def body(carry, m):
        sub = jax.random.fold_in(key, m)
        m_f = m.astype(dt)
        eps = jnp.exp(carry.log_eps)
        # clamp T into the representable leapfrog budget at the CURRENT eps
        log_T = jnp.clip(
            carry.log_T,
            carry.log_eps,
            carry.log_eps + jnp.log(jnp.asarray(max_leapfrog, dt)),
        )
        traj_len = jnp.exp(log_T)
        u = halton_u(m)
        new_state, pos_prop, mom_prop, alpha_c = _jittered_step(
            target, carry.state, sub, eps, traj_len, u, max_leapfrog
        )
        alpha = jnp.mean(alpha_c).astype(dt)

        # -- trajectory length: Adam ascent on log T ---------------------
        g = _chees_grad_logT(
            carry.state.positions, pos_prop, mom_prop, alpha_c, u * traj_len
        ).astype(dt)
        adam_m = beta1 * carry.adam_m + (1.0 - beta1) * g
        adam_v = beta2 * carry.adam_v + (1.0 - beta2) * g * g
        m_hat = adam_m / (1.0 - beta1**m_f)
        v_hat = adam_v / (1.0 - beta2**m_f)
        log_T = log_T + adam_lr * m_hat / (jnp.sqrt(v_hat) + adam_eps)

        # -- step size: Hoffman & Gelman Alg. 6 (nuts.rs:676-691) --------
        frac = 1.0 / (m_f + T_0)
        h_bar = (1.0 - frac) * carry.h_bar + frac * (target_accept - alpha)
        log_eps = mu - jnp.sqrt(m_f) / GAMMA * h_bar
        w = m_f ** (-KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * carry.log_eps_bar
        log_T_bar = w * log_T + (1.0 - w) * carry.log_T_bar

        new_carry = _CheesCarry(new_state, log_eps, log_eps_bar, h_bar,
                                log_T, log_T_bar, adam_m, adam_v)
        return new_carry, (alpha, jnp.exp(log_T), jnp.exp(log_eps))

    init = _CheesCarry(
        state,
        jnp.log(jnp.asarray(eps0, dt)),
        jnp.zeros((), dt),
        jnp.zeros((), dt),
        jnp.log(jnp.asarray(traj_len0, dt)),
        jnp.log(jnp.asarray(traj_len0, dt)),
        jnp.zeros((), dt),
        jnp.zeros((), dt),
    )
    carry, (alphas, t_trace, eps_trace) = lax.scan(
        body, init, jnp.arange(1, n_adapt + 1)
    )
    eps = jnp.exp(carry.log_eps_bar)
    traj_len = jnp.clip(jnp.exp(carry.log_T_bar), eps, eps * max_leapfrog)
    trace = {"alpha": alphas, "traj_len": t_trace, "eps": eps_trace}
    return carry.state, eps, traj_len, trace


def chees_hmc_kernel(
    target: Target,
    step_size: float,
    traj_len: float,
    max_leapfrog: int = 1024,
):
    """Build ``(init_fn, step_fn)`` for jittered-trajectory HMC — the
    production kernel ChEES adaptation tunes.

    Each step integrates for time ``u * traj_len`` with ``u ~ U(0, 1)``
    drawn from the step key (iid rather than the warmup's Halton sequence —
    a counter-free state keeps the kernel a drop-in for the runner/
    checkpoint machinery; iid jitter preserves detailed balance for the
    same reason step-size jitter does, and the quasi-random advantage only
    matters for the warmup's gradient estimates). The leapfrog count
    ``clip(ceil(u * traj_len / step_size), 1, max_leapfrog)`` is a shared
    scalar, so all chains stay in lockstep; the mean count is
    ``~traj_len / (2 * step_size)``.

    State/contract identical to ``ops/hmc.py`` (``HMCState``; one gradient
    evaluation per leapfrog via the cached half-step recurrence), so the
    runner, progress, sharding, and checkpoint paths all apply unchanged.
    """
    if step_size <= 0.0:
        raise ValueError(f"step_size must be > 0, got {step_size}")
    if traj_len <= 0.0:
        raise ValueError(f"traj_len must be > 0, got {traj_len}")

    def init_fn(positions: jax.Array) -> HMCState:
        logp, grad = target.batch_logp_and_grad(positions)
        return HMCState(positions=positions, logp=logp, grad=grad)

    def step_fn(state: HMCState, key: jax.Array) -> HMCState:
        dtype = state.positions.dtype
        u = jax.random.uniform(jax.random.fold_in(key, 2), (), dtype)
        state, _, _, _ = _jittered_step(
            target, state, key, step_size,
            jnp.asarray(traj_len, dtype), u, max_leapfrog,
        )
        return state

    return init_fn, step_fn
