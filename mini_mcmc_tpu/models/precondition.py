"""Whitening preconditioner (mass-matrix adaptation, the lockstep way).

Diagonal or dense "metric" support for the gradient-based samplers, built
as a COORDINATE TRANSFORM rather than a kernel change: running standard
unit-metric HMC/NUTS on the whitened target ``logp_y(y) = logp_x(L y)``
is exactly equivalent to running HMC/NUTS with mass matrix ``M = (L L^T)^-1``
on the original target (Neal 2011, sec. 4.1 — the classical equivalence;
samples map back as ``x = L y``). That design keeps every parity-critical
kernel untouched (the reference has no metric at all — this is a
beyond-reference feature, see PARITY.md), and the sample cube is
un-whitened on the fly inside the collection scan (one fused
multiply/matmul per recorded row, never a second cube).

The estimator is lockstep-native: with thousands of chains, ONE cross-chain
covariance snapshot of the current positions (a single ``[C, D]`` reduction)
estimates the target covariance far better than the long single-chain
warmup windows CPU samplers need — so adaptation here is "run a short
warmup, whiten from the chain ensemble, continue":

    hmc = HMC(target, init, eps, L).seed(0)
    hmc.run(0, 500)                                # equilibrate
    pre = estimate_preconditioner(hmc.positions, kind="dense")
    hmc2 = HMC(target, init, eps, L, metric=pre).seed(1)

(or the one-call convenience ``hmc.reconditioned(kind="dense")``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .base import Target

#: dc-form wrapping unrolls into scalar ops (D for diag, D^2 for dense);
#: beyond this dimension the dc forms are left to ``Target.dc_forms()``'s
#: derivation from the whitened batch form.
_DENSE_DC_MAX_DIM = 16

#: float32 matmuls of the whitening maps run at full precision: a GPU
#: would otherwise be free to run them in TF32 (about three decimal
#: digits), which would move every whitened sample.
_HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class Preconditioner:
    """An affine whitening map ``x = L y`` (``y = L^-1 x``).

    ``kind``: ``"diag"`` (``L = diag(scale)``) or ``"dense"`` (``L`` lower
    triangular, e.g. a Cholesky factor of the estimated target covariance).
    Arrays are float32 (float64 under ``jax_enable_x64``) jnp arrays; they
    enter jitted programs as constants.
    """

    kind: str
    scale: jax.Array | None = None  # [D], kind == "diag"
    chol: jax.Array | None = None  # [D, D] lower-tri, kind == "dense"

    def __post_init__(self):
        if self.kind not in ("diag", "dense"):
            raise ValueError(
                f"kind must be 'diag' or 'dense', got {self.kind!r}"
            )
        arr = self.scale if self.kind == "diag" else self.chol
        want = 1 if self.kind == "diag" else 2
        if arr is None or getattr(arr, "ndim", None) != want:
            raise ValueError(
                f"kind={self.kind!r} needs a {want}-D "
                f"{'scale' if want == 1 else 'chol'} array; got "
                f"{type(arr).__name__}"
            )

    @property
    def dim(self) -> int:
        return (self.scale if self.kind == "diag" else self.chol).shape[0]

    def sigma_min(self) -> float:
        """Smallest scale of the map (min singular value of L) — the
        stiffest-direction width, used to rescale tuned step sizes into
        whitened coordinates (``eps_y = eps_x / sigma_min`` keeps the
        stability margin of the stiffest dimension)."""
        import numpy as np

        if self.kind == "diag":
            return float(np.min(np.abs(np.asarray(self.scale))))
        return float(
            np.linalg.svd(np.asarray(self.chol), compute_uv=False)[-1]
        )

    # -- maps on [..., D] (trailing feature axis) --------------------------
    def to_x(self, y: jax.Array) -> jax.Array:
        """Un-whiten: ``[..., D]`` y-coordinates -> x-coordinates."""
        if self.kind == "diag":
            return y * self.scale.astype(y.dtype)
        return jnp.matmul(y, self.chol.astype(y.dtype).T, precision=_HI)

    def to_y(self, x: jax.Array) -> jax.Array:
        """Whiten: ``[..., D]`` x-coordinates -> y-coordinates."""
        if self.kind == "diag":
            return x / self.scale.astype(x.dtype)
        # L is lower-triangular: solve L y = x for each row of x
        flat = x.reshape(-1, x.shape[-1])
        sol = jax.scipy.linalg.solve_triangular(
            self.chol.astype(x.dtype), flat.T, lower=True
        ).T
        return sol.reshape(x.shape)

    def grad_to_y(self, g: jax.Array) -> jax.Array:
        """Chain rule: x-space gradient ``[..., D]`` -> y-space
        (``g_y = L^T g_x``)."""
        if self.kind == "diag":
            return g * self.scale.astype(g.dtype)
        return jnp.matmul(g, self.chol.astype(g.dtype), precision=_HI)

    def logdet(self) -> jax.Array:
        """``log |det L|`` (the normalization shift of the whitened
        density: ``p_y(y) = p_x(L y) |det L|``)."""
        d = self.scale if self.kind == "diag" else jnp.diag(self.chol)
        return jnp.sum(jnp.log(d))


def estimate_preconditioner(
    positions: jax.Array, kind: str = "diag", *, reg: float = 1e-8
) -> Preconditioner:
    """Estimate a whitening map from a ``[C, D]`` chain ensemble.

    One cross-chain moment snapshot — the lockstep analog of Stan's warmup
    covariance windows. ``reg`` ridges the estimate (relative to the mean
    variance) so degenerate ensembles stay invertible.
    """
    if kind not in ("diag", "dense"):
        raise ValueError(f"kind must be 'diag' or 'dense', got {kind!r}")
    dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    x = jnp.asarray(positions, dt)
    if x.ndim != 2 or x.shape[0] < 2:
        raise ValueError(
            f"positions must be [n_chains >= 2, D]; got shape {x.shape}"
        )
    var = jnp.var(x, axis=0, ddof=1)  # sample moment, like the dense branch
    ridge = reg * jnp.mean(var) + 1e-30
    if kind == "diag":
        return Preconditioner(kind="diag", scale=jnp.sqrt(var + ridge))
    delta = x - jnp.mean(x, axis=0, keepdims=True)
    cov = jnp.matmul(delta.T, delta, precision=_HI) / (x.shape[0] - 1)
    cov = cov + ridge * jnp.eye(cov.shape[0], dtype=cov.dtype)
    return Preconditioner(kind="dense", chol=jnp.linalg.cholesky(cov))


def _wrap_dc_forms(target: Target, pre: Preconditioner):
    """Whiten the chains-on-lanes (``[D, ...]``) forms.

    The dc forms are elementwise/broadcast jnp ops only, so both maps are
    unrolled into scalar multiplies with Python-float coefficients (like
    the concrete-coefficient dc forms in ``models/gaussian.py``); dims
    beyond ``_DENSE_DC_MAX_DIM`` leave the dc forms out (``Target.dc_forms()``
    then derives them from the whitened batch form). Coefficients are
    fetched with ONE host transfer (per-element ``float()`` on device
    arrays would synchronise D^2 times).
    """
    if target.logp_dc is None and target.grad_dc is None:
        return None, None
    if pre.dim > _DENSE_DC_MAX_DIM:
        return None, None
    import numpy as np

    if pre.kind == "diag":
        s = np.asarray(pre.scale).tolist()

        def x_dc(y_dc):
            return jnp.concatenate(
                [(y_dc[d] * s[d])[None] for d in range(len(s))], axis=0
            )

        def g_to_y(g_dc):
            return jnp.concatenate(
                [(g_dc[d] * s[d])[None] for d in range(len(s))], axis=0
            )
    else:
        ell = np.asarray(pre.chol).tolist()
        d_ = len(ell)

        def x_dc(y_dc):
            # x_i = sum_{j<=i} L[i][j] y_j (L lower-triangular)
            rows = []
            for i in range(d_):
                acc = ell[i][0] * y_dc[0]
                for j in range(1, i + 1):
                    acc = acc + ell[i][j] * y_dc[j]
                rows.append(acc[None])
            return jnp.concatenate(rows, axis=0)

        def g_to_y(g_dc):
            # g_y_i = sum_{j>=i} L[j][i] g_x_j  (L^T g)
            rows = []
            for i in range(d_):
                acc = ell[i][i] * g_dc[i]
                for j in range(i + 1, d_):
                    acc = acc + ell[j][i] * g_dc[j]
                rows.append(acc[None])
            return jnp.concatenate(rows, axis=0)

    logp_dc = grad_dc = None
    if target.logp_dc is not None:
        def logp_dc(y_dc, _f=target.logp_dc):
            return _f(x_dc(y_dc))
    if target.grad_dc is not None:
        def grad_dc(y_dc, _f=target.grad_dc):
            return g_to_y(_f(x_dc(y_dc)))
    return logp_dc, grad_dc


def precondition_target(target: Target, metric: Preconditioner) -> Target:
    """The whitened target ``logp_y(y) = logp_x(L y)``.

    All supplied forms are wrapped (batched, analytic gradient, normalized,
    chains-on-lanes); gradients use the chain rule ``g_y = L^T g_x`` so an
    analytic x-space gradient stays analytic. ``logp_normalized`` gains the
    ``log |det L|`` volume term (it is the density of ``y``, used only by
    diagnostics).
    """
    logp_batch = grad = logp_normalized = None

    def logp(y, _f=target.logp):
        return _f(metric.to_x(y))

    if target.logp_batch is not None:
        def logp_batch(ys, _f=target.logp_batch):
            return _f(metric.to_x(ys))

    if target.grad is not None:
        def grad(y, _f=target.grad):
            return metric.grad_to_y(_f(metric.to_x(y)))

    if target.logp_normalized is not None:
        def logp_normalized(y, _f=target.logp_normalized):
            return _f(metric.to_x(y)) + metric.logdet().astype(y.dtype)

    logp_dc, grad_dc = _wrap_dc_forms(target, metric)

    return Target(
        logp=logp,
        logp_batch=logp_batch,
        grad=grad,
        logp_normalized=logp_normalized,
        logp_dc=logp_dc,
        grad_dc=grad_dc,
    )
