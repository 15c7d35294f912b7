"""Gaussian targets and proposals.

Reimplements (behaviorally) the reference's concrete distributions:
``Gaussian2D`` (/root/reference/src/distributions.rs:158-206),
``DiffableGaussian2D`` (:212-316) and ``IsotropicGaussian`` (:344-402),
as pure-function ``Target``/``Proposal`` records operating on jnp arrays.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .base import Proposal, Target

#: float32 matmuls in the densities run at full precision: a GPU would
#: otherwise be free to run them in TF32 (about three decimal digits).
_HI = jax.lax.Precision.HIGHEST


def _quad(diff, inv_cov):
    """``diff @ inv_cov @ diff`` for one ``[D]`` state at full precision."""
    return jnp.dot(jnp.dot(diff, inv_cov, precision=_HI), diff, precision=_HI)


def _concrete_floats(*xs):
    """Python floats of ``xs``, or ``None`` when any is a JAX tracer.

    The hand-written ``_dc`` (chains-on-lanes) forms bake their
    coefficients in as Python floats at construction. When a target is
    built with traced mean/cov (e.g. inside ``jit``/``vmap`` over
    hyperparameters), returning ``None`` drops the hand-written forms so
    construction still succeeds (``Target.dc_forms`` then derives them from
    the batch form)."""
    try:
        return tuple(float(x) for x in xs)
    except (jax.errors.ConcretizationTypeError, jax.errors.TracerArrayConversionError):
        return None


def gaussian2d(mean, cov) -> Target:
    """2D Gaussian target with unnormalized and normalized log densities.

    Matches ``Gaussian2D::unnorm_logp`` / ``Normalized::logp``
    (/root/reference/src/distributions.rs:166-206): the unnormalized form is
    the pure quadratic, the normalized form adds ``-ln(2*pi) - 0.5*ln|det|``.
    """
    mean = jnp.asarray(mean)
    cov = jnp.asarray(cov)
    a, b = cov[0, 0], cov[0, 1]
    c, d = cov[1, 0], cov[1, 1]
    det = a * d - b * c
    inv_cov = jnp.array([[d, -b], [-c, a]]) / det

    def unnorm_logp(x):
        diff = x - mean.astype(x.dtype)
        return -0.5 * _quad(diff, inv_cov.astype(x.dtype))

    def logp_normalized(x):
        term_1 = -jnp.log(jnp.asarray(2.0 * math.pi, x.dtype))
        term_2 = -0.5 * jnp.log(jnp.abs(det)).astype(x.dtype)
        diff = x - mean.astype(x.dtype)
        return term_1 + term_2 - 0.5 * _quad(diff, inv_cov.astype(x.dtype))

    # chains-on-lanes form: the 2x2 quadratic expanded scalar-wise with
    # Python-float coefficients (see _concrete_floats; None when mean/cov
    # are traced).
    coeffs = _concrete_floats(
        mean[0], mean[1],
        inv_cov[0, 0], inv_cov[0, 1], inv_cov[1, 0], inv_cov[1, 1],
    )
    logp_dc = None
    if coeffs is not None:
        m0, m1, ic00, ic01, ic10, ic11 = coeffs

        def logp_dc(pos_dc):
            d0 = pos_dc[0] - m0
            d1 = pos_dc[1] - m1
            return -0.5 * (
                ic00 * d0 * d0 + (ic01 + ic10) * d0 * d1 + ic11 * d1 * d1
            )

    return Target(logp=unnorm_logp, logp_normalized=logp_normalized,
                  logp_dc=logp_dc)


def diffable_gaussian2d(mean, cov) -> Target:
    """Normalized 2D Gaussian for gradient-based samplers.

    Matches ``DiffableGaussian2D`` (/root/reference/src/distributions.rs:212-316):
    precomputed inverse covariance, log-determinant, and normalization
    constant; ``logp`` returns the *normalized* log density (the reference's
    ``unnorm_logp_batch`` includes ``norm_const``). An analytic batched form
    keeps the quadratic as one fused matmul over all chains.
    """
    mean = jnp.asarray(mean)
    cov = jnp.asarray(cov)
    det = cov[0, 0] * cov[1, 1] - cov[0, 1] * cov[1, 0]
    inv_cov = (
        jnp.array([[cov[1, 1], -cov[0, 1]], [-cov[1, 0], cov[0, 0]]]) / det
    )
    logdet = jnp.log(det)
    norm_const = -(2.0 * jnp.log(2.0 * math.pi) + logdet) / 2.0

    def logp(x):
        diff = x - mean.astype(x.dtype)
        return norm_const.astype(x.dtype) - 0.5 * _quad(
            diff, inv_cov.astype(x.dtype)
        )

    def logp_batch(positions):
        delta = positions - mean.astype(positions.dtype)[None, :]
        z = jnp.dot(delta, inv_cov.astype(positions.dtype), precision=_HI)
        quad = jnp.sum(z * delta, axis=-1)
        return norm_const.astype(positions.dtype) - 0.5 * quad

    def grad(x):
        # d/dx [-(1/2)(x-m)^T S^-1 (x-m)] = -S^-1 (x-m) (inv_cov symmetric)
        return -jnp.dot(inv_cov.astype(x.dtype), x - mean.astype(x.dtype),
                        precision=_HI)

    # chains-on-lanes forms: pos_dc is [2, ...]; the 2x2
    # quadratic is expanded scalar-wise with Python-float coefficients
    # (see _concrete_floats; None when mean/cov are traced).
    coeffs = _concrete_floats(
        mean[0], mean[1],
        inv_cov[0, 0], inv_cov[0, 1], inv_cov[1, 0], inv_cov[1, 1],
        norm_const,
    )
    logp_dc = grad_dc = None
    if coeffs is not None:
        m0, m1, ic00, ic01, ic10, ic11, nc = coeffs

        def logp_dc(pos_dc):
            d0 = pos_dc[0] - m0
            d1 = pos_dc[1] - m1
            quad = ic00 * d0 * d0 + (ic01 + ic10) * d0 * d1 + ic11 * d1 * d1
            return nc - 0.5 * quad

        def grad_dc(pos_dc):
            d0 = pos_dc[0] - m0
            d1 = pos_dc[1] - m1
            g0 = -(ic00 * d0 + ic01 * d1)
            g1 = -(ic10 * d0 + ic11 * d1)
            return jnp.concatenate([g0[None], g1[None]], axis=0)

    return Target(logp=logp, logp_batch=logp_batch, grad=grad,
                  logp_normalized=logp, logp_dc=logp_dc, grad_dc=grad_dc)


def isotropic_gaussian_proposal(std) -> Proposal:
    """Isotropic Gaussian random-walk proposal, any dimension.

    Matches ``IsotropicGaussian`` as ``Proposal``
    (/root/reference/src/distributions.rs:362-396). The log-density constant
    replicates the reference formula verbatim, including its idiosyncratic
    normalization ``-d/2 * ln(pi * std^4)`` (``distributions.rs:379-386``);
    the constant cancels in symmetric MH accept ratios.
    """

    def sample(key, current):
        noise = std * jax.random.normal(key, current.shape, current.dtype)
        return current + noise

    def logp(frm, to):
        var = std * std
        diff = to - frm
        lp = -jnp.sum(diff * diff) / (2.0 * var)
        d = frm.shape[-1]
        return lp - d * 0.5 * jnp.log(var * math.pi * std * std)

    # shape-generic: one key draws the whole [C, D] batch
    return Proposal(sample=sample, logp=logp, sample_batch=sample,
                    scaled=lambda f: isotropic_gaussian_proposal(std * f))


def gaussian_random_walk_proposal(scales) -> Proposal:
    """Gaussian random walk with per-dimension scales (a generalization the
    reference leaves to user code — its only built-in proposal is isotropic,
    /root/reference/src/distributions.rs:344-396)."""
    scales = jnp.asarray(scales)

    def sample(key, current):
        noise = scales.astype(current.dtype) * jax.random.normal(
            key, current.shape, current.dtype
        )
        return current + noise

    def logp(frm, to):
        diff = (to - frm) / scales.astype(frm.dtype)
        d = frm.shape[-1]
        return (
            -0.5 * jnp.sum(diff * diff)
            - jnp.sum(jnp.log(scales.astype(frm.dtype)))
            - 0.5 * d * jnp.log(jnp.asarray(2.0 * math.pi, frm.dtype))
        )

    return Proposal(
        sample=sample, logp=logp, sample_batch=sample,
        scaled=lambda f: gaussian_random_walk_proposal(scales * f),
    )


def isotropic_gaussian_target(std) -> Target:
    """Isotropic Gaussian as a target: ``-0.5 * sum(x^2) / std^2``
    (/root/reference/src/distributions.rs:398-402)."""

    def logp(x):
        return -0.5 * jnp.sum(x * x) / (std * std)

    return Target(logp=logp)


def standard_normal() -> Target:
    """Standard normal target ``-0.5 * sum(x^2)`` (test fixture analog of
    /root/reference/src/nuts.rs:1024-1037)."""

    def logp(x):
        return -0.5 * jnp.sum(x * x)

    def logp_batch(positions):
        return -0.5 * jnp.sum(positions * positions, axis=-1)

    def grad(x):
        return -x

    def logp_dc(pos_dc):
        return -0.5 * jnp.sum(pos_dc * pos_dc, axis=0)

    def grad_dc(pos_dc):
        return -pos_dc

    return Target(logp=logp, logp_batch=logp_batch, grad=grad,
                  logp_dc=logp_dc, grad_dc=grad_dc)


def neal_funnel(scale: float = 3.0) -> Target:
    """Neal's funnel: ``v ~ N(0, scale^2)``, ``x_i | v ~ N(0, e^v)``.

    The classic pathological geometry for gradient-based samplers (not in
    the reference's library; included as a hard-target stress case — its
    neck produces divergences that exercise ``NUTS.divergences``). State is
    ``[v, x_1, .., x_{D-1}]``.
    """
    inv_s2 = 1.0 / (scale * scale)

    def logp(state):
        v = state[0]
        x = state[1:]
        d = x.shape[0]
        return (
            -0.5 * v * v * inv_s2
            - 0.5 * jnp.sum(x * x) * jnp.exp(-v)
            - 0.5 * d * v
        )

    def logp_batch(states):
        v = states[:, 0]
        x = states[:, 1:]
        d = x.shape[1]
        return (
            -0.5 * v * v * inv_s2
            - 0.5 * jnp.sum(x * x, axis=1) * jnp.exp(-v)
            - 0.5 * d * v
        )

    def grad(state):
        v = state[0]
        x = state[1:]
        d = x.shape[0]
        e = jnp.exp(-v)
        gv = -v * inv_s2 + 0.5 * jnp.sum(x * x) * e - 0.5 * d
        gx = -x * e
        return jnp.concatenate([gv[None], gx])

    def logp_dc(p):  # [D, ...] -> [...] (elementwise only; the
        # per-coordinate sum unrolls over the static row count; grad_dc
        # comes from Target.dc_forms()'s AD derivation)
        v = p[0]
        d = p.shape[0] - 1
        emv = jnp.exp(-v)
        acc = -0.5 * v * v * inv_s2 - 0.5 * d * v
        for i in range(1, d + 1):
            acc = acc - 0.5 * p[i] * p[i] * emv
        return acc

    return Target(logp=logp, logp_batch=logp_batch, grad=grad,
                  logp_dc=logp_dc)
