"""Every float32 matmul on the sampling path states its precision.

On a GPU a ``dot`` left at default precision may run in TF32 (about three
decimal digits). These sites are pinned to ``HIGHEST``; the check reads
the precision of every ``dot_general`` in the traced program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_mcmc_tpu.models import (
    Preconditioner,
    diffable_gaussian2d,
    estimate_preconditioner,
    gaussian2d,
)
from mini_mcmc_tpu.ops.elliptical import prior_draw

_COV = [[2.0, 0.5], [0.5, 1.0]]
_X1 = jnp.array([0.3, -0.2], jnp.float32)
_XB = jnp.ones((4, 2), jnp.float32)
_CHOL = jnp.asarray(np.linalg.cholesky(np.array(_COV)), jnp.float32)


def _dot_precisions(fn, *args):
    """Precision config of every dot_general in ``fn``'s jaxpr, including
    the ones nested in sub-jaxprs."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


SITES = {
    "gaussian2d.logp": lambda: (gaussian2d([0.0, 0.0], _COV).logp, _X1),
    "gaussian2d.logp_normalized": lambda: (
        gaussian2d([0.0, 0.0], _COV).logp_normalized, _X1),
    "diffable_gaussian2d.logp": lambda: (
        diffable_gaussian2d([0.0, 1.0], _COV).logp, _X1),
    "diffable_gaussian2d.logp_batch": lambda: (
        diffable_gaussian2d([0.0, 1.0], _COV).logp_batch, _XB),
    "diffable_gaussian2d.grad": lambda: (
        diffable_gaussian2d([0.0, 1.0], _COV).grad, _X1),
    "Preconditioner.to_x": lambda: (
        Preconditioner(kind="dense", chol=_CHOL).to_x, _XB),
    "Preconditioner.grad_to_y": lambda: (
        Preconditioner(kind="dense", chol=_CHOL).grad_to_y, _XB),
    "estimate_preconditioner": lambda: (
        lambda x: estimate_preconditioner(x, "dense").chol, _XB * _X1),
    "elliptical.prior_draw": lambda: (
        lambda k: prior_draw(k, _CHOL, 8), jax.random.PRNGKey(0)),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_sampling_path_matmul_precision_is_highest(site):
    fn, arg = SITES[site]()
    precisions = _dot_precisions(fn, arg)
    assert precisions, f"{site}: no dot_general traced"
    for p in precisions:
        assert p is not None, f"{site}: precision left at default"
        assert tuple(p) == (jax.lax.Precision.HIGHEST,) * 2, (site, p)
