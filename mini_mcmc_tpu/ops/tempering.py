"""Parallel tempering / replica exchange (beyond-reference capability).

The standard remedy for multimodal targets that defeat single-temperature
samplers (Swendsen & Wang 1986; Geyer 1991): each logical chain runs T
replicas against the tempered densities ``beta_t * logp`` for a ladder
``1 = beta_0 > beta_1 > ... > beta_{T-1} > 0``, and neighboring replicas
periodically exchange states with the Metropolis rule

    log alpha_swap = (beta_t - beta_{t+1}) * (logp(x_{t+1}) - logp(x_t)).

Hot replicas see a nearly-flat landscape and hop between modes; exchanges
percolate those jumps down to the cold (beta = 1) replica, whose trajectory
is the sample. The Rust reference has no tempering.

Batched design: the temperature ladder is just another batch dimension —
all ``T * C`` replicas advance in one lockstep random-walk-Metropolis batch
(with the per-temperature proposal scale ``sigma / sqrt(beta_t)``, matching
the tempered density's width), and a swap sweep is a pair of ladder-axis
shifts + elementwise selects: even pairs on even steps, odd pairs on odd
steps (the standard alternating scheme), decided for all chains at once. No
per-replica loops, no gathers, no host round-trips; the whole step compiles
into the collection scan like every other kernel.

Two layout decisions:

- **Chains minor**: state is ``[T, D, C]``, NOT ``[T, C, D]`` — tempering's
  typical targets are LOW-dimensional, so with chains as the contiguous
  minor axis every elementwise op walks C consecutive elements instead of
  a minor axis of width D = 1-3. ``Target.logp_dc`` is used when
  available; otherwise ``batch_logp`` runs on a transposed view.
- **Swaps as shift + select, not gather**: accepted pairs are disjoint
  (alternating parity), so "apply all swaps" is two ladder-axis
  neighbor-shifts combined with elementwise `where` — XLA fuses it into
  the surrounding step, where a `take_along_axis` lowers to a real gather.

The state keeps the ladder axis SEPARATE from the chain axis so multi-chip
sharding lands on chains: ``parallel.shard_sampler_state`` reads
``PTState.CHAIN_AXIS_INDEX``, places chains over the mesh and replicates
the (small) ladder axis, the within-temperature sweep stays embarrassingly
parallel, and the swap shifts run along the REPLICATED ladder axis —
device-local, zero collectives in the sampling scan (pinned by
``tests/test_parallel.py``). Where a thread-per-chain design needs
cross-worker state exchange for swaps, this layout needs two local shifts.

The recorded sample cube contains ONLY the cold replicas (``[C, N, D]``);
hot replicas are internal state (checkpointed with it). A streaming EWMA of
per-(pair, chain) swap acceptance is carried in the state — the quantity
practitioners use to tune the ladder (aim for roughly 20-40%).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp

from ..models.base import Target

#: EWMA weight for the streaming swap-acceptance diagnostic (matches the
#: spirit of the trackers' ALPHA=0.01 acceptance EWMA, stats.py).
_SWAP_EWMA_ALPHA = 0.05


class PTState(NamedTuple):
    #: [T, D, C] chains-on-lanes replica batch; rung 0 is cold (beta = 1)
    positions: jax.Array
    raw_logp: jax.Array  # [T, C] UNtempered target log density cache
    parity: jax.Array  # int32 scalar: which pair parity swaps next
    #: [T-1, C] EWMA of each (pair, chain)'s swap-accept indicator. Kept
    #: PER CHAIN so the hot loop reduces nothing across the (sharded)
    #: chain axis — the ladder-mean is taken at read time
    #: (ParallelTempering.swap_acceptance), outside the sampling scan.
    swap_accept: jax.Array


#: Chain-axis index per field (None = replicate), consumed by
#: ``parallel.shard_sampler_state``: chains are the LAST axis of the
#: position batch here, and the ladder/pair axes must be replicated so
#: swap shifts stay device-local.
PTState.CHAIN_AXIS_INDEX = {
    "positions": 2,
    "raw_logp": 1,
    "parity": None,
    "swap_accept": 1,
}


def geometric_betas(n_temps: int, beta_min: float = 0.01) -> tuple:
    """A geometric temperature ladder ``1 -> beta_min`` (the default
    choice: equal log-spacing gives roughly uniform swap rates when the
    target's energy scale is self-similar)."""
    if n_temps < 2:
        raise ValueError(f"n_temps must be >= 2, got {n_temps}")
    if not 0.0 < beta_min < 1.0:
        raise ValueError(f"beta_min must be in (0, 1), got {beta_min}")
    import numpy as np

    return tuple(float(b) for b in np.geomspace(1.0, beta_min, n_temps))


def tune_betas(betas: Sequence[float], swap_acceptance,
               n_temps: Optional[int] = None) -> tuple:
    """Re-space a temperature ladder from measured swap rates.

    Schedule tuning via the communication barrier (Syed et al. 2021,
    "Non-reversible parallel tempering", JRSS-B, sec. 5.2): each pair's
    rejection rate ``r_t = 1 - acc_t`` estimates the local communication
    cost; the cumulative barrier ``Lambda(beta)`` is its piecewise-linear
    interpolation along the ladder, and the optimal schedule places knots
    at EQUAL barrier increments. Given the streaming per-pair EWMA from a
    run (``ParallelTempering.swap_acceptance``), this returns a new ladder
    with the same endpoints (``1.0`` and ``betas[-1]``) whose pairs should
    reject roughly equally — iterate run -> tune -> run to convergence
    (one round is usually enough in practice).

    ``n_temps`` resizes the ladder (the barrier estimate interpolates to
    any knot count); default keeps ``len(betas)``. The round-trip-optimal
    count puts each pair's rejection near 50% — if the tuned ladder's
    expected per-pair rejection ``Lambda_total / (n_temps - 1)`` is far
    below that, the ladder is oversized for the target.

    Pure host-side numpy (a between-runs utility, not scan code).
    """
    import numpy as np

    betas = np.asarray(betas, np.float64)
    acc = np.asarray(swap_acceptance, np.float64)
    if betas.ndim != 1 or acc.shape != (betas.shape[0] - 1,):
        raise ValueError(
            f"swap_acceptance must have length len(betas)-1; got "
            f"{acc.shape} for {betas.shape[0]} betas"
        )
    if n_temps is None:
        n_temps = betas.shape[0]
    if n_temps < 2:
        raise ValueError(f"n_temps must be >= 2, got {n_temps}")
    # Rejection rates, floored so a fully-mixing pair still contributes an
    # epsilon of barrier (keeps Lambda strictly increasing => invertible).
    rej = np.clip(1.0 - acc, 1e-6, 1.0)
    lam = np.concatenate([[0.0], np.cumsum(rej)])  # barrier at each knot
    # Invert the piecewise-linear Lambda at equal barrier increments:
    # lam is increasing along the ladder index (np.interp's x), betas are
    # the (decreasing) knot values to interpolate.
    levels = np.linspace(0.0, lam[-1], n_temps)
    new = np.interp(levels, lam, betas)
    new[0], new[-1] = betas[0], betas[-1]
    # Guard against duplicate knots from zero-width barrier segments.
    for i in range(1, n_temps):
        if new[i] >= new[i - 1]:
            new[i] = new[i - 1] * 0.999999
    return tuple(float(b) for b in new)


def _shift_up(x):
    """[T, ...] -> rung t holds rung t+1's value (last rung: self)."""
    return jnp.concatenate([x[1:], x[-1:]], axis=0)


def _shift_down(x):
    """[T, ...] -> rung t holds rung t-1's value (first rung: self)."""
    return jnp.concatenate([x[:1], x[:-1]], axis=0)


def tempering_kernel(target: Target, betas: Sequence[float], *,
                     proposal_std=1.0, n_inner: int = 1,
                     steps_per_call: int = 1):
    """Build ``(init_fn, step_fn)`` for replica-exchange random-walk MH.

    ``init_fn(positions [C, D]) -> PTState`` replicates the cold-chain
    initial positions across the ladder. One ``step_fn`` call is
    ``n_inner`` lockstep within-temperature MH sweeps followed by one
    alternating-parity swap sweep. ``proposal_std``: cold-chain random-walk
    scale (scalar or per-dimension ``[D]``); replica t proposes with
    ``proposal_std / sqrt(beta_t)``.
    """
    betas = tuple(float(b) for b in betas)
    if len(betas) < 2:
        raise ValueError("betas must have >= 2 temperatures "
                         f"(got {betas!r}); tempering with one replica "
                         "is plain MH")
    if abs(betas[0] - 1.0) > 1e-12:
        raise ValueError(f"betas[0] must be 1.0 (the cold chain), "
                         f"got {betas[0]}")
    if any(b2 >= b1 for b1, b2 in zip(betas, betas[1:])) or betas[-1] <= 0:
        raise ValueError("betas must be strictly decreasing and positive, "
                         f"got {betas!r}")
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    t_count = len(betas)
    beta_col = jnp.asarray(betas, jnp.float32)[:, None]  # [T, 1]

    if target.logp_dc is not None:
        logp_l = jax.vmap(target.logp_dc)  # [T, D, C] -> [T, C]
    else:
        logp_l = jax.vmap(lambda p: target.batch_logp(p.T))

    def init_fn(positions: jax.Array) -> PTState:
        lp = target.batch_logp(positions)  # [C]
        return PTState(
            positions=jnp.tile(positions.T[None], (t_count, 1, 1)),
            raw_logp=jnp.tile(lp[None], (t_count, 1)),
            parity=jnp.zeros((), jnp.int32),
            swap_accept=jnp.zeros(
                (t_count - 1, positions.shape[0]), jnp.float32
            ),
        )

    def _inner_sweep(key, positions, raw_logp, sigma_l):
        """One within-temperature MH update for all [T, C] replicas."""
        k_prop, k_u = jax.random.split(key)
        noise = jax.random.normal(k_prop, positions.shape, positions.dtype)
        proposed = positions + sigma_l * noise
        prop_lp = logp_l(proposed)  # [T, C]
        log_acc = beta_col * (prop_lp - raw_logp)
        u = jax.random.uniform(k_u, log_acc.shape, log_acc.dtype)
        accept = log_acc > jnp.log(u)
        return (
            jnp.where(accept[:, None, :], proposed, positions),
            jnp.where(accept, prop_lp, raw_logp),
        )

    def step_fn(state: PTState, key: jax.Array) -> PTState:
        k_inner, k_swap = jax.random.split(key)

        # Per-replica proposal scale: sigma / sqrt(beta) — sigma may be a
        # scalar or per-dimension [D]; broadcast over the [T, D, C] batch.
        sigma = jnp.atleast_1d(
            jnp.asarray(proposal_std, state.positions.dtype)
        )
        inv_sqrt_beta = 1.0 / jnp.sqrt(beta_col[:, 0])  # [T]
        sigma_l = inv_sqrt_beta[:, None, None] * sigma[None, :, None]

        positions, raw_logp = state.positions, state.raw_logp
        for sub in jax.random.split(k_inner, n_inner):
            positions, raw_logp = _inner_sweep(
                sub, positions, raw_logp, sigma_l
            )

        # Swap sweep: pairs (t, t+1) with t = parity (mod 2), all chains
        # at once.
        pos_l, lp_l = positions, raw_logp
        t_idx = jnp.arange(t_count - 1)
        pair_active = (t_idx % 2) == (state.parity % 2)  # [T-1]
        delta_beta = beta_col[:-1, 0] - beta_col[1:, 0]  # [T-1] > 0
        log_acc = delta_beta[:, None] * (lp_l[1:] - lp_l[:-1])  # [T-1, C]
        u = jax.random.uniform(k_swap, log_acc.shape, log_acc.dtype)
        swap = pair_active[:, None] & (log_acc > jnp.log(u))  # [T-1, C]

        # Apply every accepted swap at once: rung t of an accepted pair
        # takes rung t+1's state and vice versa. Pairs are disjoint
        # (alternating parity), so this is two neighbor-shifts along the
        # ladder axis + elementwise selects — no gather.
        lower = jnp.pad(swap, ((0, 1), (0, 0)))  # [T, C] t takes from t+1
        upper = jnp.pad(swap, ((1, 0), (0, 0)))  # [T, C] t takes from t-1
        pos_l = jnp.where(
            lower[:, None, :], _shift_up(pos_l),
            jnp.where(upper[:, None, :], _shift_down(pos_l), pos_l),
        )
        lp_l = jnp.where(
            lower, _shift_up(lp_l),
            jnp.where(upper, _shift_down(lp_l), lp_l),
        )

        # Streaming per-(pair, chain) swap-accept EWMA, only for this
        # step's active pairs — elementwise over [T-1, C], so nothing
        # reduces across the (sharded) chain axis inside the scan.
        swap_accept = jnp.where(
            pair_active[:, None],
            (1.0 - _SWAP_EWMA_ALPHA) * state.swap_accept
            + _SWAP_EWMA_ALPHA * swap.astype(jnp.float32),
            state.swap_accept,
        )
        return PTState(
            positions=pos_l,
            raw_logp=lp_l,
            parity=(state.parity + 1) % 2,
            swap_accept=swap_accept,
        )

    if steps_per_call > 1:
        # PT-specific scan block: record ONLY the cold rung (already in the
        # user [C, D] layout) inside the scan body. The generic
        # runner.make_scan_block_fn would stack the full [K, T, D, C]
        # replica state and let the sampler slice rung 0 afterwards — a
        # T-times transient HBM spike per block.
        def block_fn(state: PTState, key: jax.Array):
            def body(carry, sub):
                carry = step_fn(carry, sub)
                return carry, carry.positions[0].T

            return jax.lax.scan(
                body, state, jax.random.split(key, steps_per_call)
            )

        block_fn.rows_mapped = True
        step_fn.block_fn = block_fn
        step_fn.block_size = steps_per_call

    return init_fn, step_fn
