"""Stochastic-gradient MCMC: SGLD, pSGLD, SGHMC.

Beyond-reference capability (the Rust reference at /root/reference stops at
full-gradient samplers, /root/reference/src/hmc.rs:36-432): the
minibatch-gradient family that makes Bayesian posterior sampling tractable
when the dataset no longer fits in one gradient evaluation — the
large-scale-production regime this framework targets.

- **SGLD** (Welling & Teh, ICML 2011): Langevin dynamics driven by an
  unbiased minibatch estimate of ``grad log pi``; with a decaying step size
  the MH correction is provably unnecessary.
- **pSGLD** (Li et al., AAAI 2016): SGLD with an RMSProp diagonal
  preconditioner, the practical fix for badly scaled posteriors (the
  stochastic-gradient analog of the ``metric=`` whitening the exact
  samplers use, ``models/precondition.py``).
- **SGHMC** (Chen, Fox & Guestrin, ICML 2014): underdamped Langevin with
  friction, the momentum variant that survives gradient noise.

Batched design:

- The gradient estimator is where the FLOPs are, and it is built so XLA can
  hand them to the matmul units: :func:`minibatch_grad` hands the **whole
  minibatch** to the user's ``log_like(position, batch) -> scalar`` in one
  call, so a regression/classification likelihood is a single
  ``[B, D] @ [D]`` matmul which, vmapped over the ``[C, D]`` chain batch,
  becomes one ``[B, D] @ [D, C]`` matmul per step — never a per-datum
  Python loop, never per-datum vmap unless the user writes one.
- One shared minibatch per step across all chains (default): a single
  ``[B]`` gather from the device-resident dataset feeds every chain, so
  data movement is O(B) per step, not O(C*B). Each chain individually
  remains an exact SGLD/SGHMC chain (the estimator stays unbiased
  per-chain); sharing only correlates chains *within* a step, which
  slightly reduces cross-chain variance-reduction — flip
  ``shared_batch=False`` to pay the O(C*B) gather for fully independent
  estimates (e.g. when cross-chain averaging IS the estimator).
- No accept/reject, no tree building: the step is a fused
  gather -> matmul -> elementwise update, which is exactly the shape XLA
  fuses into a handful of kernels; ``steps_per_call`` blocks K steps into
  one scan body like the MH/HMC block kernels (``runner.make_block_runner``).
- Step-size schedules run on-device: the state carries an ``int32`` step
  counter and the schedule is traced into the compiled step, so a decaying
  step size costs nothing and checkpoints resume mid-schedule for free
  (the counter is part of the state pytree, ``checkpoint.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import jax
import jax.numpy as jnp

from ..models.base import Target
from ..runner import make_scan_block_fn


class SGLDState(NamedTuple):
    positions: jax.Array  # [C, D]
    sq_avg: jax.Array  # [C, D] RMSProp EWMA of grad^2 ([0] when unused)
    step: jax.Array  # scalar int32 (drives step-size schedules)


class SGHMCState(NamedTuple):
    positions: jax.Array  # [C, D]
    momenta: jax.Array  # [C, D] velocity v (position-increment units)
    step: jax.Array  # scalar int32


def polynomial_decay(a: float, b: float, gamma: float) -> Callable:
    """Welling & Teh (2011) eq. 2 schedule: ``eps_t = a * (b + t)^-gamma``.

    Pass the result as ``step_size=`` to :class:`~mini_mcmc_tpu.SGLD` /
    :class:`~mini_mcmc_tpu.SGHMC`. ``gamma in (0.5, 1]`` satisfies the
    decreasing-step-size conditions under which SGLD needs no MH
    correction.

    Example:
        >>> from mini_mcmc_tpu import polynomial_decay
        >>> sched = polynomial_decay(1e-2, 10.0, 0.55)
        >>> float(sched(0)) > float(sched(1000))
        True
    """
    if gamma < 0:
        raise ValueError(f"gamma must be >= 0, got {gamma}")

    def schedule(t: jax.Array) -> jax.Array:
        return a * (b + t.astype(jnp.float32)) ** (-gamma)

    return schedule


def minibatch_grad(
    log_prior: Callable,
    log_like: Callable,
    data,
    batch_size: int,
    *,
    shared_batch: bool = True,
) -> Callable:
    """Unbiased minibatch estimator of ``grad log pi`` for SGMCMC.

    ``log pi(x) = log_prior(x) + sum_i log_like_i(x)``; the estimator
    replaces the sum with ``(N/B) * log_like(x, batch)`` over ``B`` indices
    drawn uniformly with replacement — unbiased for any ``B``.

    Args:
        log_prior: ``[D] -> scalar`` log prior density (jnp ops only).
        log_like: ``(position [D], batch) -> scalar`` — the SUMMED
            log-likelihood of the minibatch at one position. Receiving the
            whole batch (not one datum) lets regression-style likelihoods
            be a single matmul, which vmapped over chains stays one matmul.
        data: a ``[N, ...]`` array or a pytree of arrays sharing the
            leading ``N`` axis (e.g. ``(X, y)``); ``batch`` passed to
            ``log_like`` has the same structure with leading axis ``B``.
            Keep it on-device: it is gathered, never copied.
        batch_size: minibatch size ``B``.
        shared_batch: draw one batch per step shared by all chains (one
            ``[B]`` gather; default) vs. an independent batch per chain
            (``[C, B]`` gather — O(C*B) data movement).

    Returns:
        ``grad_fn(positions [C, D], key) -> [C, D]`` stochastic gradients.
    """
    leaves = jax.tree_util.tree_leaves(data)
    if not leaves:
        raise ValueError("data must contain at least one array")
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError(
                "all data leaves must share the leading axis; got "
                f"{[leaf.shape[0] for leaf in leaves]}"
            )
    if not 1 <= batch_size <= n:
        raise ValueError(
            f"batch_size must be in [1, {n}], got {batch_size}"
        )
    scale = n / batch_size

    def logp_hat(x: jax.Array, batch) -> jax.Array:
        return log_prior(x) + scale * log_like(x, batch)

    grad_one = jax.grad(logp_hat)

    def grad_fn(positions: jax.Array, key: jax.Array) -> jax.Array:
        c = positions.shape[0]
        if shared_batch:
            idx = jax.random.randint(key, (batch_size,), 0, n)
            batch = jax.tree_util.tree_map(
                lambda a: jnp.take(a, idx, axis=0), data
            )
            return jax.vmap(grad_one, in_axes=(0, None))(positions, batch)
        idx = jax.random.randint(key, (c, batch_size), 0, n)
        batch = jax.tree_util.tree_map(
            lambda a: jnp.take(a, idx, axis=0), data
        )  # leaves [C, B, ...]
        return jax.vmap(grad_one)(positions, batch)

    return grad_fn


def data_parallel_grad(
    log_prior: Callable,
    log_like: Callable,
    data,
    batch_size: int,
    mesh,
    *,
    axis: Optional[str] = None,
) -> Callable:
    """Data-SHARDED stochastic gradient for SGMCMC over a device mesh.

    :func:`minibatch_grad` keeps the dataset device-resident on one chip;
    this is its multi-chip sibling for datasets that exceed a single
    chip's HBM. Shards of ``data`` (split on the leading axis) live on
    separate devices along a mesh axis; every step each device draws
    ``batch_size / n_shards`` rows from its LOCAL shard, computes the
    partial minibatch-likelihood gradient for the (replicated) ``[C, D]``
    chain batch, and the partials reduce with ONE ``psum`` over the device
    interconnect — the single deliberate hot-loop collective in the
    framework (the sampling kernels themselves are zero-communication by
    construction, ``runner.py``; here the data cannot be local, so the
    reduction is irreducible and is one ``[C, D]``-sized all-reduce per
    step).

    The estimator is unbiased for equal-size shards: uniform draws within
    each shard, ``batch_size/n_shards`` per shard, scaled by ``N/B``
    exactly as in :func:`minibatch_grad` (stratified-by-shard sampling —
    each datum is still counted with weight ``N/B`` in expectation).

    Args:
        log_prior / log_like / batch_size: as :func:`minibatch_grad`
            (``log_like`` receives the device-local minibatch).
        data: ``[N, ...]`` array or pytree sharing the leading axis. ``N``
            and ``batch_size`` must divide by the mesh-axis size. The
            helper places it with a leading-axis :class:`NamedSharding`;
            pre-sharded inputs are accepted only in exactly that layout
            (anything else raises — a silent per-step reshard would add
            the collective this function promises not to).
        mesh: a :class:`jax.sharding.Mesh` (e.g.
            ``mini_mcmc_tpu.parallel.chain_mesh()``).
        axis: mesh axis name to shard rows over (default: the mesh's
            first axis). Positions stay replicated over this axis, so
            chains must NOT also be sharded over it.

    Returns:
        ``grad_fn(positions [C, D], key) -> [C, D]``, usable with
        :class:`~mini_mcmc_tpu.SGLD` / :class:`~mini_mcmc_tpu.SGHMC`.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    try:
        shard_map = jax.shard_map  # jax >= 0.8
    except AttributeError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map

    leaves = jax.tree_util.tree_leaves(data)
    if not leaves:
        raise ValueError("data must contain at least one array")
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError(
                "all data leaves must share the leading axis; got "
                f"{[leaf.shape[0] for leaf in leaves]}"
            )
    if axis is None:
        axis = mesh.axis_names[0]
    n_shards = mesh.shape[axis]
    if n % n_shards != 0:
        raise ValueError(
            f"N={n} must divide by the '{axis}' mesh axis ({n_shards}); "
            "pad or trim the dataset to equal shards (unequal shards "
            "bias the estimator)"
        )
    if batch_size % n_shards != 0 or not 1 <= batch_size <= n:
        raise ValueError(
            f"batch_size must be in [1, {n}] and divide by the mesh "
            f"axis size {n_shards}, got {batch_size}"
        )
    b_loc = batch_size // n_shards
    n_loc = n // n_shards
    scale = n / batch_size

    def _place(a):
        want = NamedSharding(mesh, P(axis, *([None] * (a.ndim - 1))))
        have = getattr(a, "sharding", None)
        if have is not None and not have.is_fully_replicated:
            # Pre-sharded input: accept ONLY the expected leading-axis
            # layout. Anything else (different mesh/axis/dimension) would
            # make shard_map silently reshard on every call — an extra
            # per-step collective the docstring promises not to add.
            if have.is_equivalent_to(want, a.ndim):
                return a
            raise ValueError(
                "data_parallel_grad: a data leaf is pre-sharded as "
                f"{have}, which does not match the required leading-axis "
                f"sharding {want}; pass it unsharded (it will be placed) "
                "or shard it over the mesh's "
                f"'{axis}' axis on dimension 0"
            )
        return jax.device_put(a, want)

    data = jax.tree_util.tree_map(_place, data)

    grad_prior = jax.grad(log_prior)
    grad_like = jax.grad(lambda x, batch: scale * log_like(x, batch))

    data_spec = jax.tree_util.tree_map(
        lambda a: P(axis, *([None] * (a.ndim - 1))), data
    )

    def _local(local_data, positions, key):
        # distinct index stream per shard; the SAME replicated key yields
        # a deterministic per-device derivation via the axis index
        k = jax.random.fold_in(key, jax.lax.axis_index(axis))
        idx = jax.random.randint(k, (b_loc,), 0, n_loc)
        batch = jax.tree_util.tree_map(
            lambda a: jnp.take(a, idx, axis=0), local_data
        )
        # Differentiate DEVICE-LOCALLY: under vma-aware shard_map
        # (jax >= 0.8/0.9), grad w.r.t. the *replicated* positions would
        # auto-insert a psum in the transpose (each device's "partial"
        # becomes the full cross-shard sum), and the explicit psum below
        # would then over-count by n_shards. Casting positions to
        # device-varying first keeps the grad local so the ONE explicit
        # psum is the single intended reduction (verified by the
        # unbiasedness + collective-count tests in test_parallel.py).
        pos_v = jax.lax.pcast(positions, axis, to="varying")
        g = jax.vmap(grad_like, in_axes=(0, None))(pos_v, batch)
        return jax.lax.psum(g, axis)

    sharded = shard_map(
        _local, mesh=mesh, in_specs=(data_spec, P(), P()), out_specs=P()
    )

    def grad_fn(positions: jax.Array, key: jax.Array) -> jax.Array:
        return jax.vmap(grad_prior)(positions) + sharded(
            data, positions, key
        ).astype(positions.dtype)

    return grad_fn


def target_grad(target: Target) -> Callable:
    """Full-batch ``grad_fn`` from a :class:`~mini_mcmc_tpu.models.Target`
    (ignores the key) — lets SGLD/SGHMC run as exact unadjusted Langevin /
    underdamped Langevin on any existing target, e.g. to isolate
    discretization bias from gradient noise."""

    def grad_fn(positions: jax.Array, key: jax.Array) -> jax.Array:
        del key
        return target.batch_logp_and_grad(positions)[1]

    return grad_fn


def _resolve_step_size(step_size) -> Callable:
    if callable(step_size):
        return step_size
    eps = float(step_size)
    if eps <= 0:
        raise ValueError(f"step_size must be positive, got {eps}")
    return lambda t: jnp.float32(eps)


def sgld_kernel(
    grad_fn: Callable,
    step_size: Union[float, Callable],
    *,
    temperature: float = 1.0,
    preconditioner: Optional[str] = None,
    rms_decay: float = 0.99,
    rms_eps: float = 1e-5,
    steps_per_call: int = 1,
):
    """Build ``(init_fn, step_fn)`` for (p)SGLD.

    One step (Welling & Teh 2011 eq. 1; Li et al. 2016 eq. 5 with
    ``preconditioner="rmsprop"``)::

        g   = grad_fn(x, key)                      # stochastic grad
        G   = 1 / (sqrt(V) + rms_eps)              # pSGLD only (V: EWMA g^2)
        x  += eps/2 * G * g + sqrt(eps * T * G) * xi,   xi ~ N(0, I)

    Args:
        grad_fn: ``(positions [C, D], key) -> [C, D]`` — from
            :func:`minibatch_grad` or :func:`target_grad`.
        step_size: constant float, or a schedule ``(step int32) -> eps``
            (:func:`polynomial_decay`), traced on-device.
        temperature: ``T`` scales the injected noise; ``T=0`` is plain SGD,
            ``T=1`` targets the posterior, ``T>1`` flattens it.
        preconditioner: ``None`` or ``"rmsprop"`` (pSGLD). Following Li
            et al.'s implementation, the ``Gamma`` curvature-drift term is
            dropped (it vanishes as the EWMA equilibrates).
        rms_decay / rms_eps: pSGLD EWMA decay and regularizer.
        steps_per_call: > 1 attaches a K-step block function
            (``step_fn.block_fn``/``block_size``), same contract as the
            MH/HMC/Gibbs block kernels.
    """
    if preconditioner not in (None, "rmsprop"):
        raise ValueError(
            f'preconditioner must be None or "rmsprop", got {preconditioner!r}'
        )
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    eps_of = _resolve_step_size(step_size)

    def init_fn(positions: jax.Array) -> SGLDState:
        positions = jnp.asarray(positions)
        # The unused sentinel is a SCALAR zero (not shape [0]): orbax
        # refuses to serialize zero-size arrays, and checkpoints must
        # round-trip every sampler state (checkpoint.py).
        sq_avg = (
            jnp.zeros_like(positions)
            if preconditioner == "rmsprop"
            else jnp.zeros((), positions.dtype)
        )
        return SGLDState(
            positions=positions, sq_avg=sq_avg, step=jnp.int32(0)
        )

    def step_fn(state: SGLDState, key: jax.Array) -> SGLDState:
        k_batch, k_noise = jax.random.split(key)
        x = state.positions
        # Pin the carry dtype: a user grad_fn may promote (e.g. float64
        # constants under jax_enable_x64) and a widened carry breaks scan.
        g = grad_fn(x, k_batch).astype(x.dtype)
        eps = eps_of(state.step).astype(x.dtype)
        xi = jax.random.normal(k_noise, x.shape, x.dtype)
        if preconditioner == "rmsprop":
            sq_avg = rms_decay * state.sq_avg + (1.0 - rms_decay) * g * g
            # Bias-corrected EWMA (Adam-style): without it V starts at 0
            # and the first preconditioner is 1/rms_eps — a 1e5x step that
            # blows the chains out before V equilibrates.
            debias = 1.0 - rms_decay ** (state.step.astype(x.dtype) + 1.0)
            precond = 1.0 / (jnp.sqrt(sq_avg / debias) + rms_eps)
            x = (x + 0.5 * eps * precond * g
                 + jnp.sqrt(eps * temperature * precond) * xi)
        else:
            sq_avg = state.sq_avg
            x = x + 0.5 * eps * g + jnp.sqrt(eps * temperature) * xi
        return SGLDState(positions=x, sq_avg=sq_avg, step=state.step + 1)

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn


def sghmc_kernel(
    grad_fn: Callable,
    step_size: Union[float, Callable],
    *,
    friction: float = 0.1,
    temperature: float = 1.0,
    steps_per_call: int = 1,
):
    """Build ``(init_fn, step_fn)`` for SGHMC.

    One step (Chen, Fox & Guestrin 2014 eq. 15, the
    ``v = eps * momentum`` parametrization their released code uses)::

        v  = (1 - alpha) * v + eps * grad_fn(x, key)
               + sqrt(2 * alpha * eps * T) * xi,   xi ~ N(0, I)
        x += v

    The friction ``alpha`` absorbs gradient noise: with exact gradients and
    ``alpha -> 0`` this is HMC without MH; with minibatch gradients,
    ``alpha`` must dominate the (unknown) noise scale — 0.01..0.1 is the
    usual range. Momenta start at zero and equilibrate within
    ``~1/alpha`` steps (discard at least that many).

    Args: as :func:`sgld_kernel`; ``friction`` in (0, 1].
    """
    if not 0.0 < friction <= 1.0:
        raise ValueError(f"friction must be in (0, 1], got {friction}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    eps_of = _resolve_step_size(step_size)

    def init_fn(positions: jax.Array) -> SGHMCState:
        positions = jnp.asarray(positions)
        return SGHMCState(
            positions=positions,
            momenta=jnp.zeros_like(positions),
            step=jnp.int32(0),
        )

    def step_fn(state: SGHMCState, key: jax.Array) -> SGHMCState:
        k_batch, k_noise = jax.random.split(key)
        x, v = state.positions, state.momenta
        g = grad_fn(x, k_batch).astype(x.dtype)
        eps = eps_of(state.step).astype(x.dtype)
        xi = jax.random.normal(k_noise, x.shape, x.dtype)
        v = ((1.0 - friction) * v + eps * g
             + jnp.sqrt(2.0 * friction * eps * temperature) * xi)
        x = x + v
        return SGHMCState(positions=x, momenta=v, step=state.step + 1)

    if steps_per_call > 1:
        step_fn.block_fn = make_scan_block_fn(step_fn, steps_per_call)
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
