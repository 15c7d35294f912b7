"""Batched Hamiltonian Monte Carlo step kernel.

Batched redesign of the reference's data-parallel HMC
(``HMC::step``/``leapfrog``, /root/reference/src/hmc.rs:304-431): all chains
advance in lockstep as ``[n_chains, D]`` tensors; the leapfrog integrator is
a ``lax.scan`` over L steps that keeps the reference's fused half-step trick
(cache ``eps/2 * grad`` between iterations so each leapfrog step costs one
gradient evaluation, hmc.rs:323-325, :408-425).

Improvements over the reference's evaluation count (numerically identical):
the gradient and log density at the current position are carried in the
state, so a full HMC step costs exactly ``n_leapfrog`` gradient evaluations
(the reference re-evaluates at the trajectory start and once more at the
trajectory end, hmc.rs:317-324, :429-430). The reference's ``set_seed`` also
never determinizes the accept draws (its CPU-generated uniforms are dead
code, hmc.rs:355-363); here every draw comes from the explicit step key.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.base import Target
from ..runner import make_scan_block_fn


class HMCState(NamedTuple):
    positions: jax.Array  # [C, D]
    logp: jax.Array  # [C] cached target log density at positions
    grad: jax.Array  # [C, D] cached gradient at positions


def hmc_kernel(
    target: Target,
    step_size: float,
    n_leapfrog: int,
    unroll: int | bool = 8,
    jitter: float = 0.0,
    steps_per_call: int = 1,
):
    """Build ``(init_fn, step_fn)`` for batched HMC.

    ``init_fn(positions [C, D]) -> HMCState``
    ``step_fn(state, key) -> HMCState``

    ``unroll`` controls leapfrog-scan unrolling: at small D the integrator
    body is a few elementwise ops, so per-iteration loop overhead is a
    large share of a step and unrolling several leapfrog steps into one
    loop body amortizes it.

    ``jitter`` > 0 scales the step size per sampler step by a shared
    Uniform[1-jitter, 1+jitter] factor (Neal 2011's standard remedy for
    fixed-(eps, L) periodicity; the reference has no jitter). The factor is
    drawn independently of the state, so detailed balance is preserved.
    With jitter == 0 the PRNG stream is identical to the unjittered kernel.

    ``step_fn.leapfrog(pos, mom, logp, grad, eps)`` is the integrator the
    step runs (L leapfrog steps from the given momenta), exposed so it can
    be checked against a reference on its own.

    ``steps_per_call`` > 1 additionally attaches a K-step block function to
    the returned ``step_fn`` (``step_fn.block_fn``, ``step_fn.block_size``):
    ``block_fn(state, key) -> (state, rows [K, C, D])`` advances K full
    sampler steps and returns every intermediate position, as an XLA scan
    over K steps. Use with ``runner.make_block_runner``.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")

    def init_fn(positions: jax.Array):
        logp, grad = target.batch_logp_and_grad(positions)
        return HMCState(positions=positions, logp=logp, grad=grad)

    def leapfrog(pos, mom, logp, grad, eps):
        """L leapfrog steps with cached half-step gradient summands
        (hmc.rs:397-431). Returns (pos', mom', logp', grad')."""
        half_eps = eps * 0.5

        def body(carry, _):
            pos, mom, _, grad = carry
            mom = mom + grad * half_eps
            pos = pos + eps * mom
            logp, grad = target.batch_logp_and_grad(pos)
            mom = mom + grad * half_eps
            return (pos, mom, logp, grad), None

        (pos, mom, logp, grad), _ = lax.scan(
            body,
            (pos, mom, logp, grad),
            None,
            length=n_leapfrog,
            unroll=min(unroll, n_leapfrog) if unroll else 1,
        )
        return pos, mom, logp, grad

    def step_eps(state: HMCState, key: jax.Array, eps: jax.Array):
        """One HMC step at a (possibly traced) step size, also
        returning the cross-chain mean Metropolis acceptance probability
        (NaN-divergent proposals count as 0) — the hook ``ops/adapt.py``'s
        dual-averaging warmup drives. This IS the production step body:
        ``step_fn`` delegates here (alpha is dead code under jit when
        unused), so the tuner adapts exactly the kernel that runs."""
        n_chains = state.positions.shape[0]
        key_mom, key_u = jax.random.split(key)
        eps = jnp.asarray(eps, state.positions.dtype)
        mom0 = jax.random.normal(
            key_mom, state.positions.shape, state.positions.dtype
        )
        h_current = -state.logp + 0.5 * jnp.sum(mom0 * mom0, axis=1)
        pos_prop, mom_prop, logp_prop, grad_prop = leapfrog(
            state.positions, mom0, state.logp, state.grad, eps
        )
        h_proposed = -logp_prop + 0.5 * jnp.sum(mom_prop * mom_prop, axis=1)
        # Accept iff H_cur - H_prop >= ln(u) per chain (hmc.rs:343-376).
        accept_logp = h_current - h_proposed
        alpha_c = jnp.exp(jnp.minimum(accept_logp, 0.0))
        alpha = jnp.mean(jnp.where(jnp.isnan(alpha_c), 0.0, alpha_c))
        u = jax.random.uniform(key_u, (n_chains,), accept_logp.dtype)
        accept = accept_logp >= jnp.log(u)  # NaN compares False
        positions = jnp.where(accept[:, None], pos_prop, state.positions)
        logp = jnp.where(accept, logp_prop, state.logp)
        grad = jnp.where(accept[:, None], grad_prop, state.grad)
        return HMCState(positions, logp, grad), alpha

    def step_fn(state: HMCState, key: jax.Array) -> HMCState:
        dtype = state.positions.dtype
        if jitter > 0.0:
            key_eps = jax.random.fold_in(key, 2)
            factor = 1.0 + jitter * (
                2.0 * jax.random.uniform(key_eps, (), dtype) - 1.0
            )
            eps = jnp.asarray(step_size, dtype) * factor
        else:
            eps = jnp.asarray(step_size, dtype)

        state, _ = step_eps(state, key, eps)
        return state

    step_fn.step_eps = step_eps
    step_fn.leapfrog = leapfrog

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
