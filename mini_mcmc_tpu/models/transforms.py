"""Constrained-parameter transforms: sample unconstrained, report natural.

Every gradient sampler in this framework (like the reference's, which only
ever sees unconstrained targets — /root/reference/src/distributions.rs has
no constraint machinery) works on all of R^D. Real models have positive
scales and bounded probabilities; the standard treatment is a per-coordinate
bijection ``x = g(y)`` with the change-of-variables term
``log |det dg/dy|`` added to the log density, so the chain explores y in
R^D while the user thinks in x. ``examples/eight_schools_nuts.py``
hand-rolls this for ``tau = exp(log_tau)``; this module makes it
first-class:

    transform = CoordinateTransform({1: positive()}, dim=10)
    t_y = transform.wrap(target_x)        # Target over y, Jacobian included
    nuts = NUTS(t_y, transform.to_y(x0))  # start from natural-space inits
    x_samples = transform.to_x(nuts.run(1000, 500))

Design notes:

- Bijectors are ELEMENTWISE scalar maps; ``CoordinateTransform`` groups
  coordinates by bijector and applies each group with one masked
  ``jnp.where`` over the whole ``[..., D]`` array — no per-coordinate
  Python loop in the traced path, so a d=10,000 state transforms in O(1)
  fused ops per distinct bijector.
- Derivatives (for analytic-gradient wrapping and the chains-on-lanes
  ``grad_dc`` form) come from elementwise VJPs of the forward/log_det
  closures — the same ones-cotangent trick as
  :func:`~mini_mcmc_tpu.models.base.derive_grad_dc` — so a custom
  ``Bijector`` needs only ``forward``/``inverse``/``log_det``.
- ``wrap()`` carries every form a target may have: hand-written
  ``logp_dc``/``grad_dc`` compose per-row (the dc layout indexes
  coordinates as ``p[d]``, so per-coordinate bijections are natural
  there); built-in forwards are total on R (``exp``, ``sigmoid``), so the
  masked application never produces NaNs in untaken branches.
"""

from __future__ import annotations

import dataclasses
import functools
import math as _math
from typing import Callable, Mapping, Optional, Sequence

import jax
import jax.numpy as jnp

from .base import Target

#: like precondition._DENSE_DC_MAX_DIM: beyond this the per-row dc wrapping
#: is left out (Target.dc_forms() then derives from the wrapped batch form)
_DC_MAX_DIM = 64


@dataclasses.dataclass(frozen=True)
class Bijector:
    """An elementwise bijection ``x = forward(y)`` from R onto an interval.

    Attributes:
        forward: ``y -> x``, total on R (applied under a mask to the whole
            state array — a partial function would NaN untaken lanes).
        inverse: ``x -> y`` on the bijector's range (used eagerly for
            ``to_y`` on initial positions; never differentiated).
        log_det: ``y -> log |d forward / dy|`` elementwise.
        name: display name for reprs/errors.
    """

    forward: Callable
    inverse: Callable
    log_det: Callable
    name: str = "bijector"


@functools.lru_cache(maxsize=None)
def identity() -> Bijector:
    """x = y (the default for unlisted coordinates)."""
    return Bijector(lambda y: y, lambda x: x, jnp.zeros_like, "identity")


def _soft_saturate(lim_of_finfo):
    """A C^2 pre-squash ``y -> y'`` that is EXACTLY the identity on the
    core ``|y| <= L/2`` and saturates smoothly onto ``(-L, L)`` beyond
    (``sign(y) * (L/2 + L/2 * tanh((|y| - L/2) / (L/2)))``), with ``L``
    chosen per dtype so the downstream ``exp``/``sigmoid`` NEVER leaves
    representable range.

    Why: a hard-saturating composition like ``log1p(-sigmoid(y))`` hits
    float saturation a few units into the tail (sigma(y) == 1.0 in f32 at
    y ~ 17), turning an adaptation excursion into -inf log density with
    NaN gradient — which freezes the chain (cached-gradient state) and
    poisons dual averaging (found on the conjugate-Beta example). Because
    the squash is a smooth strictly-increasing bijection with its exact
    Jacobian accounted, the pushforward density of x is EXACTLY the
    user's density (restricted to an astronomically wide core range —
    e.g. positive() spans (1e-35, 4e34) in float32); nothing is
    approximated, and log density + gradient stay finite for ALL y, so
    excursions recover instead of NaN-ing.

    Returns ``(pre, pre_log_det, pre_inverse)``.
    """

    def _params(dtype):
        lim = float(lim_of_finfo(jnp.finfo(dtype)))
        a = 0.5 * lim
        return a, lim - a  # core half-width, saturation scale

    def pre(y):
        a, s = _params(y.dtype)
        ay = jnp.abs(y)
        sat = jnp.sign(y) * (a + s * jnp.tanh((ay - a) / s))
        return jnp.where(ay <= a, y, sat)

    def pre_log_det(y):
        a, s = _params(y.dtype)
        u = (jnp.abs(y) - a) / s
        # log sech^2(u) STABLY: 2 log 2 - 2u - 2 log1p(e^-2u). The naive
        # log1p(-tanh(u)^2) hits tanh == 1.0 exactly for u > ~19 and
        # returns -inf with a NaN gradient — the very failure mode this
        # squash exists to remove.
        log_sech2 = (2.0 * _math.log(2.0) - 2.0 * u
                     - 2.0 * jnp.log1p(jnp.exp(-2.0 * u)))
        return jnp.where(jnp.abs(y) <= a, jnp.zeros_like(y), log_sech2)

    def pre_inverse(z):
        a, s = _params(z.dtype)
        az = jnp.abs(z)
        arg = jnp.clip((az - a) / s, 0.0, 1.0 - 1e-7)
        sat = jnp.sign(z) * (a + s * jnp.arctanh(arg))
        return jnp.where(az <= a, z, sat)

    return pre, pre_log_det, pre_inverse


#: exp() stays comfortably inside float range over the squashed image.
#: math.log on host floats, NOT jnp.log: these run inside traced kernel
#: bodies and a device op here would leak a tracer into the closure.
_EXP_LIM = _soft_saturate(lambda fi: 0.9 * _math.log(float(fi.max)))
#: sigmoid() stays >= one ulp away from 0 and 1 over the squashed image
_SIG_LIM = _soft_saturate(lambda fi: -_math.log(float(fi.eps)))


@functools.lru_cache(maxsize=None)
def positive() -> Bijector:
    """x = exp(y'): R -> (0, inf) — positive scales (tau, sigma).

    ``y'`` is the soft-saturated pre-image (:func:`_soft_saturate`):
    exactly ``y`` for ``|y| <= ~40`` (f32) / ``~319`` (f64), smoothly
    bounded beyond so ``exp`` never overflows to inf (NaN gradients) or
    underflows to an x the user's ``log(x)`` turns into -inf."""
    pre, pre_ld, pre_inv = _EXP_LIM
    return Bijector(
        lambda y: jnp.exp(pre(y)),
        lambda x: pre_inv(jnp.log(x)),
        lambda y: pre(y) + pre_ld(y),
        "positive",
    )


@functools.lru_cache(maxsize=None)
def lower_bounded(low: float) -> Bijector:
    """x = low + exp(y'): R -> (low, inf)."""
    low = float(low)
    pre, pre_ld, pre_inv = _EXP_LIM
    return Bijector(
        lambda y: low + jnp.exp(pre(y)),
        lambda x: pre_inv(jnp.log(x - low)),
        lambda y: pre(y) + pre_ld(y),
        f"lower_bounded({low:g})",
    )


@functools.lru_cache(maxsize=None)
def upper_bounded(high: float) -> Bijector:
    """x = high - exp(y'): R -> (-inf, high). NOTE: DECREASING in y (the
    log-Jacobian is of the absolute derivative)."""
    high = float(high)
    pre, pre_ld, pre_inv = _EXP_LIM
    return Bijector(
        lambda y: high - jnp.exp(pre(y)),
        lambda x: pre_inv(jnp.log(high - x)),
        lambda y: pre(y) + pre_ld(y),
        f"upper_bounded({high:g})",
    )


@functools.lru_cache(maxsize=None)
def interval(low: float, high: float) -> Bijector:
    """x = low + (high - low) * sigmoid(y'): R -> (low, high) — bounded
    parameters (probabilities, correlations).

    ``y'`` is soft-saturated (exactly ``y`` for ``|y| <= ~8`` in f32 /
    ``~18`` in f64) so ``sigmoid`` stays at least one ulp inside (0, 1):
    a user density's ``log(p)``/``log1p(-p)`` remains finite with finite
    gradients for ALL y — adaptation excursions recover instead of
    freezing the chain on a NaN gradient."""
    low, high = float(low), float(high)
    if not high > low:
        raise ValueError(f"need high > low, got ({low}, {high})")
    width = high - low
    pre, pre_ld, pre_inv = _SIG_LIM

    def fwd(y):
        return low + width * jax.nn.sigmoid(pre(y))

    def inv(x):
        p = (x - low) / width
        return pre_inv(jnp.log(p) - jnp.log1p(-p))

    def ld(y):
        # log(width * sigmoid(y') * (1 - sigmoid(y'))) + log dy'/dy:
        yp = pre(y)
        return (
            jnp.log(width) - yp - 2.0 * jnp.log1p(jnp.exp(-yp)) + pre_ld(y)
        )

    return Bijector(fwd, inv, ld, f"interval({low:g}, {high:g})")


def _elem_grad(f: Callable) -> Callable:
    """Elementwise derivative of an elementwise map via the ones-cotangent
    VJP (the derive_grad_dc trick — valid because the Jacobian is
    diagonal)."""

    def df(y):
        out, vjp = jax.vjp(f, y)
        (g,) = vjp(jnp.ones_like(out))
        return g

    return df


class CoordinateTransform:
    """Per-coordinate bijector stack over a ``[..., D]`` state.

    Args:
        bijectors: either a sequence of ``D`` :class:`Bijector` (one per
            coordinate; use :func:`identity` for unconstrained ones) or a
            ``{coordinate_index: Bijector}`` mapping with identity default
            (then ``dim`` is required).
        dim: state dimension (required with a mapping; checked against a
            sequence).
    """

    def __init__(self, bijectors, dim: Optional[int] = None):
        if isinstance(bijectors, Mapping):
            if dim is None:
                raise ValueError(
                    "dim is required when bijectors is a {index: Bijector} "
                    "mapping"
                )
            table = [None] * dim
            for idx, bij in bijectors.items():
                i = int(idx)
                if not -dim <= i < dim:
                    raise ValueError(
                        f"coordinate index {i} out of range for dim={dim}"
                    )
                table[i] = bij
        else:
            table = list(bijectors)
            if dim is not None and len(table) != dim:
                raise ValueError(
                    f"got {len(table)} bijectors for dim={dim}"
                )
        self.dim = len(table)
        self._table = [b if b is not None else identity() for b in table]
        # group non-identity coordinates by bijector object: one masked
        # whole-array application per distinct bijector. The builtin
        # factories are lru_cached so the natural construction
        # `{i: positive() for i in range(10_000)}` yields ONE group (one
        # masked pass), not 10,000 — custom Bijector instances group by
        # identity, so share the instance across coordinates.
        groups: dict[int, tuple[Bijector, list[int]]] = {}
        for d, bij in enumerate(self._table):
            if bij.name == "identity":
                continue
            key = id(bij)
            groups.setdefault(key, (bij, []))[1].append(d)
        import numpy as np

        self._groups = [
            (bij, jnp.asarray(np.isin(np.arange(self.dim), idxs)))
            for bij, idxs in groups.values()
        ]

    def __repr__(self):
        named = {d: b.name for d, b in enumerate(self._table)
                 if b.name != "identity"}
        return f"CoordinateTransform(dim={self.dim}, {named})"

    @property
    def is_identity(self) -> bool:
        return not self._groups

    # -- array maps (trailing coordinate axis) ------------------------------
    def to_x(self, y: jax.Array) -> jax.Array:
        """Unconstrained ``[..., D]`` -> natural coordinates."""
        x = y = jnp.asarray(y)
        for bij, mask in self._groups:
            x = jnp.where(mask, bij.forward(y), x)
        return x

    def to_y(self, x: jax.Array) -> jax.Array:
        """Natural ``[..., D]`` -> unconstrained (for initial positions).
        Masked lanes may evaluate ``inverse`` outside its range; built-in
        inverses return NaN there, which the mask discards."""
        x = jnp.asarray(x)
        y = x
        for bij, mask in self._groups:
            y = jnp.where(mask, bij.inverse(x), y)
        return y

    def log_det(self, y: jax.Array) -> jax.Array:
        """``[..., D]`` -> ``[...]`` summed log-Jacobian."""
        y = jnp.asarray(y)
        acc = jnp.zeros(y.shape[:-1], y.dtype)
        for bij, mask in self._groups:
            acc = acc + jnp.sum(
                jnp.where(mask, bij.log_det(y), jnp.zeros_like(y)), axis=-1
            )
        return acc

    def _dx_dy(self, y: jax.Array) -> jax.Array:
        """Elementwise ``d forward / dy`` over ``[..., D]`` (diagonal
        Jacobian)."""
        out = jnp.ones_like(y)
        for bij, mask in self._groups:
            out = jnp.where(mask, _elem_grad(bij.forward)(y), out)
        return out

    def _dlogdet_dy(self, y: jax.Array) -> jax.Array:
        out = jnp.zeros_like(y)
        for bij, mask in self._groups:
            out = jnp.where(mask, _elem_grad(bij.log_det)(y), out)
        return out

    # -- dc (chains-on-lanes, [D, ...]) maps --------------------------------
    def _to_x_dc(self, p):
        rows = []
        for d in range(self.dim):
            bij = self._table[d]
            rows.append(
                (p[d] if bij.name == "identity" else bij.forward(p[d]))[None]
            )
        return jnp.concatenate(rows, axis=0)

    def _log_det_dc(self, p):
        acc = jnp.zeros_like(p[0])
        for d in range(self.dim):
            bij = self._table[d]
            if bij.name != "identity":
                acc = acc + bij.log_det(p[d])
        return acc

    # -- target wrapping -----------------------------------------------------
    def wrap(self, target: Target) -> Target:
        """The unconstrained-space target
        ``logp_y(y) = logp_x(to_x(y)) + log_det(y)``.

        All supplied forms carry over: batched, analytic gradient (chain
        rule through the diagonal Jacobian), normalized (it is the density
        of ``y``), and the chains-on-lanes ``logp_dc``/``grad_dc`` forms
        (per-row composition, left out above ``_DC_MAX_DIM`` where
        ``Target.dc_forms()``'s derivation takes over). The wrapped target
        plugs into every sampler; samples come back in y-space — map them
        with :meth:`to_x`.
        """
        if self.is_identity:
            return target
        tf = self

        def logp(y, _f=target.logp):
            return _f(tf.to_x(y)) + tf.log_det(y)

        logp_batch = grad = logp_normalized = None
        if target.logp_batch is not None:
            def logp_batch(ys, _f=target.logp_batch):
                return _f(tf.to_x(ys)) + tf.log_det(ys)

        if target.grad is not None:
            def grad(y, _f=target.grad):
                return _f(tf.to_x(y)) * tf._dx_dy(y) + tf._dlogdet_dy(y)

        if target.logp_normalized is not None:
            def logp_normalized(y, _f=target.logp_normalized):
                return _f(tf.to_x(y)) + tf.log_det(y)

        logp_dc = grad_dc = None
        if self.dim <= _DC_MAX_DIM:
            if target.logp_dc is not None:
                def logp_dc(p, _f=target.logp_dc):
                    return _f(tf._to_x_dc(p)) + tf._log_det_dc(p)

            if target.grad_dc is not None:
                def grad_dc(p, _f=target.grad_dc):
                    gx = _f(tf._to_x_dc(p))
                    rows = []
                    for d in range(tf.dim):
                        bij = tf._table[d]
                        if bij.name == "identity":
                            rows.append(gx[d][None])
                        else:
                            rows.append((
                                gx[d] * _elem_grad(bij.forward)(p[d])
                                + _elem_grad(bij.log_det)(p[d])
                            )[None])
                    return jnp.concatenate(rows, axis=0)

        return Target(
            logp=logp,
            logp_batch=logp_batch,
            grad=grad,
            logp_normalized=logp_normalized,
            logp_dc=logp_dc,
            grad_dc=grad_dc,
        )


def transformed_target(
    target: Target,
    bijectors: Sequence[Bijector] | Mapping[int, Bijector],
    dim: Optional[int] = None,
):
    """One-call convenience: build the :class:`CoordinateTransform` and
    wrap ``target``. Returns ``(wrapped_target, transform)``."""
    tf = CoordinateTransform(bijectors, dim=dim)
    return tf.wrap(target), tf
