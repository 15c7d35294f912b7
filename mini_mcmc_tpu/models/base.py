"""Target / proposal / conditional abstractions as pure functions.

Batched redesign of the reference's trait surface
(``/root/reference/src/distributions.rs:65-134,485-487``):

- ``Target<T,F>::unnorm_logp(&[T]) -> F``          -> ``Target.logp`` (pure fn)
- ``GradientTarget::unnorm_logp_and_grad``          -> ``jax.value_and_grad``
- ``BatchedGradientTarget::unnorm_logp_batch``      -> ``jax.vmap`` (or an
  analytic ``logp_batch`` override for fused batched evaluation)
- ``Proposal<T,F>`` (sample/logp/set_seed)          -> ``Proposal`` (pure fns,
  explicit PRNG keys; seeding is the caller's key, not mutable state)
- ``Conditional<S>::sample(index, given)``          -> ``Conditional.sample``
  with an explicit key: ``(key, index, state) -> value``

The batched/unbatched split of the reference collapses: every sampler in this
framework operates on ``[n_chains, D]`` batches, with ``vmap`` deriving the
batched form from a per-state ``logp`` unless an analytic batched version is
supplied (which XLA can fuse better for hot paths).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Target:
    """An unnormalized target density.

    Attributes:
        logp: ``[D] -> scalar`` unnormalized log density for one state.
        logp_batch: optional analytic ``[C, D] -> [C]`` override. Defaults to
            ``vmap(logp)``.
        grad: optional analytic gradient ``[D] -> [D]``. Defaults to
            ``jax.grad(logp)``.
        logp_normalized: optional normalized log density (diagnostics), the
            analog of the reference's ``Normalized`` trait.
    """

    logp: Callable
    logp_batch: Optional[Callable] = None
    grad: Optional[Callable] = None
    logp_normalized: Optional[Callable] = None
    #: optional chains-on-lanes (chains-minor) forms: ``[D, C] -> [C]``
    #: log density and ``[D, C] -> [D, C]`` gradient (elementwise jnp ops
    #: over the lane axes only). Parallel tempering evaluates its
    #: ``[T, D, C]`` replica batch through ``logp_dc`` when present.
    logp_dc: Optional[Callable] = None
    grad_dc: Optional[Callable] = None

    def batch_logp(self, positions: jax.Array) -> jax.Array:
        """Log density for a ``[C, D]`` batch of positions -> ``[C]``."""
        if self.logp_batch is not None:
            return self.logp_batch(positions)
        return jax.vmap(self.logp)(positions)

    def batch_logp_and_grad(self, positions: jax.Array):
        """Value and gradient for a ``[C, D]`` batch -> (``[C]``, ``[C, D]``).

        Replaces the reference's detach/require_grad/backward dance
        (``/root/reference/src/distributions.rs:81-87``) with reverse-mode AD
        traced once under ``jit``.
        """
        if self.grad is not None:
            if self.logp_batch is not None:
                vals = self.logp_batch(positions)
            else:
                vals = jax.vmap(self.logp)(positions)
            grads = jax.vmap(self.grad)(positions)
            return vals, grads
        if self.logp_batch is not None:
            # Differentiate the fused batched form: sum trick gives per-row
            # gradients because rows are independent.
            vals, vjp = jax.vjp(self.logp_batch, positions)
            (grads,) = vjp(jnp.ones_like(vals))
            return vals, grads
        return jax.vmap(jax.value_and_grad(self.logp))(positions)

    def logp_and_grad(self, position: jax.Array):
        """Value and gradient for a single ``[D]`` state."""
        if self.grad is not None:
            return self.logp(position), self.grad(position)
        return jax.value_and_grad(self.logp)(position)

    def dc_forms(self):
        """``(logp_dc, grad_dc)``, the chains-on-lanes forms.

        Every missing form is derived, so a plain ``Target(logp=...)``
        has both with zero extra code (the reference's own contract: ONE
        density definition feeds everything,
        /root/reference/src/distributions.rs:78-88):

        - no ``logp_dc``: derived from the batch form with
          :func:`derive_logp_dc` (a transpose of the lanes layout; a
          hand-written chains-on-lanes form avoids the transpose).
        - no ``grad_dc``: derived from ``logp_dc`` with
          :func:`derive_grad_dc` (reverse-mode AD); a hand-written
          ``grad_dc`` remains an optional override (it can be cheaper
          when value and gradient share subexpressions).

        Hand-written forms can be checked against the batch forms with
        :func:`validate_dc_forms`, so a transposed covariance or dropped
        term raises instead of silently giving a different density.
        """
        logp_dc = self.logp_dc
        if logp_dc is None:
            logp_dc = derive_logp_dc(self.batch_logp)
        if self.grad_dc is not None:
            return logp_dc, self.grad_dc
        return logp_dc, derive_grad_dc(logp_dc)


def derive_logp_dc(batch_logp: Callable) -> Callable:
    """A chains-on-lanes ``[D, ...] -> [...]`` log density derived from a
    ``[C, D] -> [C]`` batch form by transposing the lanes layout. A
    hand-written ``Target.logp_dc`` (elementwise over the leading D axis)
    avoids the transpose.
    """

    def logp_dc(p):
        d = p.shape[0]
        lanes = p.shape[1:]
        flat = jnp.moveaxis(p, 0, -1).reshape((-1, d))
        return batch_logp(flat).reshape(lanes)

    return logp_dc


def derive_grad_dc(logp_dc: Callable) -> Callable:
    """The ``[D, ...] -> [D, ...]`` gradient of a chains-on-lanes log
    density, derived by reverse-mode AD.

    Lanes are independent chains, so the VJP of ``logp_dc`` with a ones
    cotangent IS the per-lane gradient (the sum trick). Because a valid
    ``logp_dc`` uses only elementwise/broadcast jnp ops, its transpose is
    also elementwise, like a hand-written one.

    CONTRACT: ``logp_dc`` must treat lanes independently (no reductions
    over the lane axes — only over the leading D axis). A cross-lane
    reduction makes the ones-cotangent VJP sum contributions across
    chains, silently corrupting every gradient; sampler construction
    :func:`validate_dc_forms` catches this by checking the derived gradient
    against the batch AD gradient.
    """

    def grad_dc(p):
        out, vjp = jax.vjp(logp_dc, p)
        (g,) = vjp(jnp.ones_like(out))
        return g

    return grad_dc


def validate_dc_forms(target: "Target", positions, *, rtol: float = 3e-4,
                      atol: float = 1e-4, max_rows: int = 256,
                      need_grad: bool = True) -> None:
    """Check hand-written chains-on-lanes forms against the batch forms.

    A hand-written ``logp_dc``/``grad_dc`` that disagrees with ``logp``
    (transposed covariance, dropped term, wrong sign) gives a different
    density from the batch form. This runs once, eagerly, on (up to
    ``max_rows`` of) the given positions in the ``[D, C]`` lanes layout
    and raises ``ValueError`` on mismatch. A ``Target`` with NEITHER
    hand-written form validates trivially (both derive from the batch
    form); a hand-written ``grad_dc`` is checked even when ``logp_dc`` is
    absent; the DERIVED gradient of a hand-written ``logp_dc`` is also
    checked (it is silently wrong when ``logp_dc`` reduces across lanes —
    see :func:`derive_grad_dc`).

    ``need_grad=False`` skips the derived-gradient probe for consumers
    that read only ``logp_dc`` VALUES (random-walk moves, swap ratios): a
    value-correct ``logp_dc`` whose internals couple lanes stays usable
    there. A hand-written ``grad_dc`` is still checked regardless.

    The probe runs on the CPU backend: on an accelerator the two forms
    take different compute paths (hand-written dc forms are unrolled
    scalar ops; batch forms may run float32 matmuls at reduced precision)
    and would need tolerances loose enough to mask real dropped-term
    bugs. CPU evaluation is a handful of tiny batches.
    """
    import numpy as np

    if target.logp_dc is None and target.grad_dc is None:
        return  # both forms derive from the batch form; nothing to disagree
    with _cpu_probe_ctx():
        _validate_dc_forms_impl(target, positions, np, rtol, atol, max_rows,
                                need_grad)


def _cpu_probe_ctx():
    """CPU-backend context for the validation probe (see
    :func:`validate_dc_forms`'s rationale)."""
    import contextlib

    try:
        return jax.default_device(jax.devices("cpu")[0])
    except RuntimeError:  # pragma: no cover - cpu backend always present
        return contextlib.nullcontext()


def _host_probe_rows(positions, max_rows, np):
    """First ``max_rows`` of ``positions`` as a fresh host-backed array.

    The round-trip through host matters: committed device arrays would
    otherwise pin the probe back onto their own accelerator despite
    ``jax.default_device``.
    """
    x = jnp.asarray(np.asarray(positions)[:max_rows])
    if x.ndim != 2:
        raise ValueError(
            f"positions must be [n_chains, D]; got shape {x.shape}"
        )
    return x


def _validate_dc_forms_impl(target, positions, np, rtol, atol, max_rows,
                            need_grad):
    x = _host_probe_rows(positions, max_rows, np)
    x_dc = x.T

    def _fail(form, want, got):
        err = np.abs(got - want)
        worst = int(np.nanargmax(np.where(np.isfinite(err), err, np.inf)
                                 .reshape(-1)))
        raise ValueError(
            f"Target.{form} disagrees with the batch form derived from "
            f"Target.logp/logp_batch on the initial positions: max abs "
            f"err {np.nanmax(err):.3g} (flat index {worst}: "
            f"{form}={got.reshape(-1)[worst]:.6g} vs "
            f"batch={want.reshape(-1)[worst]:.6g}). Fix the "
            "chains-on-lanes form."
        )

    def _mismatch(want, got):
        both_ninf = np.isneginf(want) & np.isneginf(got)
        close = np.isclose(got, want, rtol=rtol,
                           atol=atol * np.maximum(np.abs(want), 1.0))
        return not np.all(close | both_ninf)

    if target.logp_dc is not None:
        want_lp = np.asarray(target.batch_logp(x), np.float64)
        got_lp = np.asarray(target.logp_dc(x_dc), np.float64)
        if got_lp.shape != want_lp.shape:
            raise ValueError(
                f"Target.logp_dc returned shape {got_lp.shape} for a "
                f"[D, C] input; expected lanes shape {want_lp.shape}"
            )
        if _mismatch(want_lp, got_lp):
            _fail("logp_dc", want_lp, got_lp)

    # gradient probe: always for a hand-written grad_dc; for the derived
    # gradient only when the requesting kernel consumes gradients
    if jnp.issubdtype(x.dtype, jnp.floating) and (
            need_grad or target.grad_dc is not None):
        _, grad_dc = target.dc_forms()
        _, want_g = target.batch_logp_and_grad(x)
        want_g = np.asarray(want_g, np.float64)
        got_g = np.asarray(grad_dc(x_dc), np.float64).T
        form = "grad_dc" if target.grad_dc is not None else \
            "grad_dc (derived from logp_dc)"
        if got_g.shape != want_g.shape:
            raise ValueError(
                f"Target.{form} returned transposed shape "
                f"{got_g.T.shape} for a [D, C] input; expected [D, C] = "
                f"{want_g.T.shape}"
            )
        finite = np.isfinite(want_g)
        if _mismatch(np.where(finite, want_g, 0.0),
                     np.where(finite, got_g, 0.0)):
            _fail(form, want_g, got_g)


@dataclasses.dataclass(frozen=True)
class Proposal:
    """A proposal kernel q(x' | x) with explicit PRNG keys.

    Attributes:
        sample: ``(key, current [D]) -> proposed [D]``.
        logp: ``(from [D], to [D]) -> scalar`` log q(to | from).
        sample_batch: optional ``(key, current [C, D]) -> [C, D]`` drawing
            the whole batch from ONE key (saves the per-chain key split).
        scaled: optional ``(factor) -> Proposal`` returning this proposal
            with its length scale multiplied by ``factor`` (``factor`` may
            be a traced scalar). Enables adaptive proposal-scale tuning
            (``MetropolisHastings.tuned`` — beyond-reference; the
            reference's proposal scale is fixed forever,
            /root/reference/src/distributions.rs:344-396).
    """

    sample: Callable
    logp: Callable
    sample_batch: Optional[Callable] = None
    scaled: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class Conditional:
    """Full-conditional sampler for Gibbs (reference ``Conditional<S>``).

    Attributes:
        sample: ``(key, index, state [D]) -> scalar`` draws coordinate
            ``index`` from its full conditional given the complete state.
            Must be JAX-traceable (``index`` is a traced int under the
            coordinate sweep loop).
        sample_batch: optional ``(key, index, states [C, D]) -> [C]``
            drawing coordinate ``index`` for ALL chains from one key —
            skips the per-chain key splitting and runs the conditional as
            batched tensor ops.
    """

    sample: Callable
    sample_batch: Optional[Callable] = None
