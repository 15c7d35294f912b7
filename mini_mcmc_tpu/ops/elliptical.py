"""Batched elliptical slice sampling (Murray, Adams & MacKay 2010).

Beyond-reference capability (the Rust reference at /root/reference has no
elliptical slice sampler): the standard tuning-free sampler for posteriors
of the form

    p(x) ∝ N(x; mu, Sigma) * L(x)

— a Gaussian prior times an arbitrary likelihood, the shape of every
latent-Gaussian-process model. Each update draws an auxiliary prior sample
``nu ~ N(0, Sigma)`` and slice-samples the angle ``theta`` on the ellipse

    x(theta) = (x - mu) cos(theta) + nu sin(theta) + mu,

which passes through the current state (theta=0) and is EXACTLY invariant
under the prior — so only the likelihood enters the accept test and there
is nothing to tune: no step size, no bracket width, no acceptance-rate
target. The angle bracket ``[theta - 2pi, theta]`` always contains an
acceptable point and shrinks toward theta=0 geometrically, so the loop
terminates in a handful of iterations (Murray et al. 2010, Fig. 2).

Batched design: all chains advance in lockstep ``[C, D]`` batches; the
data-dependent angle-shrinkage loop is one masked ``lax.while_loop`` over
the whole batch with a single fused likelihood call per iteration (the
same lanes-with-masks treatment as ``ops/slice.py`` and the lockstep NUTS
in ``ops/nuts.py``). The prior draw ``nu`` is one batched matmul against
the prior Cholesky factor — one matmul, not a per-chain loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.base import Target
from ..runner import make_scan_block_fn


class EllipticalState(NamedTuple):
    positions: jax.Array  # [C, D]
    loglik: jax.Array  # [C] cached likelihood log density (NOT the prior)


def _as_scale(prior_scale, dim, dtype):
    """Normalize the prior scale spec to a ``[D, D]`` lower Cholesky.

    Accepts a scalar std, a ``[D]`` per-coordinate std vector, or a full
    ``[D, D]`` lower-triangular Cholesky factor of the prior covariance.
    """
    scale = jnp.asarray(prior_scale, dtype)
    if scale.ndim == 0:
        return scale * jnp.eye(dim, dtype=dtype)
    if scale.ndim == 1:
        if scale.shape[0] != dim:
            raise ValueError(
                f"prior scale vector has {scale.shape[0]} entries for a "
                f"{dim}-D state"
            )
        return jnp.diag(scale)
    if scale.ndim == 2:
        if scale.shape != (dim, dim):
            raise ValueError(
                f"prior Cholesky must be [{dim}, {dim}], got {scale.shape}"
            )
        return scale
    raise ValueError(
        f"prior scale must be a scalar, [D], or [D, D]; got shape "
        f"{scale.shape}"
    )


def prior_draw(key: jax.Array, chol: jax.Array, n_chains: int) -> jax.Array:
    """``nu ~ N(0, chol chol^T)`` for every chain: one ``[C, D] @ [D, D]``
    matmul, at full float32 precision (a GPU may otherwise run it in TF32,
    about three decimal digits)."""
    z = jax.random.normal(key, (n_chains, chol.shape[0]), chol.dtype)
    return jnp.matmul(z, chol.T, precision=jax.lax.Precision.HIGHEST)


def elliptical_kernel(loglik: Target, *, prior_mean=0.0, prior_scale=1.0,
                      max_shrink: int = 32, steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for batched elliptical slice sampling.

    Args:
        loglik: the LIKELIHOOD ``L(x)`` as a :class:`Target` (only
            ``logp`` is used; gradient-free). The Gaussian prior is NOT
            part of it — the sampler handles the prior exactly through
            the ellipse construction. Passing the full posterior here
            (prior included) silently samples prior-squared-times-
            likelihood.
        prior_mean: prior mean ``mu`` — scalar or ``[D]``.
        prior_scale: prior covariance spec — a scalar std, a ``[D]``
            per-coordinate std vector, or a ``[D, D]`` lower-triangular
            Cholesky factor ``L`` with ``Sigma = L L^T``.
        max_shrink: bound on angle-shrinkage iterations. The bracket
            shrinks toward theta=0 geometrically and theta=0 (the current
            state) is always acceptable, so the cap binding means float
            pathology; a capped lane keeps its current state (identity
            update, still invariant).
        steps_per_call: > 1 attaches a K-step block function
            (``step_fn.block_fn``/``block_size``), same contract as the
            other kernels' blocks.

    ``init_fn(positions [C, D]) -> EllipticalState``
    ``step_fn(state, key) -> EllipticalState``
    """
    if max_shrink < 1:
        raise ValueError(f"max_shrink must be >= 1, got {max_shrink}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")

    def init_fn(positions: jax.Array) -> EllipticalState:
        positions = jnp.asarray(positions)
        return EllipticalState(
            positions=positions, loglik=loglik.batch_logp(positions)
        )

    def step_fn(state: EllipticalState, key: jax.Array) -> EllipticalState:
        n_chains, dim = state.positions.shape
        dtype = state.positions.dtype
        mu = jnp.broadcast_to(
            jnp.asarray(prior_mean, dtype), (dim,)
        )
        chol = _as_scale(prior_scale, dim, dtype)

        k_nu, k_y, k_theta, k_loop = jax.random.split(key, 4)
        nu = prior_draw(k_nu, chol, n_chains)
        centered = state.positions - mu

        # Slice height on the LIKELIHOOD only: log y = loglik(x) + log U.
        logy = state.loglik + jnp.log(
            jax.random.uniform(k_y, (n_chains,), dtype)
        )

        # Initial angle and bracket (Murray et al. 2010, Fig. 2 lines 4-6):
        # theta ~ U(0, 2pi), bracket [theta - 2pi, theta].
        two_pi = jnp.asarray(2.0 * jnp.pi, dtype)
        theta0 = two_pi * jax.random.uniform(k_theta, (n_chains,), dtype)
        t_min0 = theta0 - two_pi
        t_max0 = theta0

        def propose(theta):
            return (centered * jnp.cos(theta)[:, None]
                    + nu * jnp.sin(theta)[:, None] + mu)

        def cond(carry):
            _, _, _, _, _, done, it, _ = carry
            return jnp.any(~done) & (it < max_shrink)

        def body(carry):
            theta, t_min, t_max, x_new, ll_new, done, it, k = carry
            cand = propose(theta)
            ll_cand = loglik.batch_logp(cand)
            accept = ~done & (ll_cand > logy)
            x_new = jnp.where(accept[:, None], cand, x_new)
            ll_new = jnp.where(accept, ll_cand, ll_new)
            done = done | accept
            # Shrink toward theta = 0 (the current state): rejected theta
            # becomes the bracket edge on its own side.
            t_min = jnp.where(~done & (theta < 0.0), theta, t_min)
            t_max = jnp.where(~done & (theta >= 0.0), theta, t_max)
            k, sub = jax.random.split(k)
            u = jax.random.uniform(sub, (n_chains,), dtype)
            theta = t_min + u * (t_max - t_min)
            return theta, t_min, t_max, x_new, ll_new, done, it + 1, k

        init_done = jnp.zeros((n_chains,), bool)
        _, _, _, x_new, ll_new, _, _, _ = lax.while_loop(
            cond, body,
            (theta0, t_min0, t_max0, state.positions, state.loglik,
             init_done, jnp.int32(0), k_loop),
        )
        return EllipticalState(positions=x_new, loglik=ll_new)

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
