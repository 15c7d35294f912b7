"""Dtype-generality: the kernels run in float64 under jax_enable_x64.

The reference is generic over ``T: Float`` (f32/f64 backends,
/root/reference/src/hmc.rs:38, /root/reference/src/distributions.rs:65-134);
here the kernels are dtype-generic over the initial positions' dtype.
``jax_enable_x64`` is process-global, so the check runs in a subprocess
(the main suite stays x32, the accelerator default).
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import mini_mcmc_tpu as mm
from mini_mcmc_tpu.models import (
    gaussian2d, isotropic_gaussian_proposal, rosenbrock_nd,
)

t = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
mh = mm.MetropolisHastings(
    t, isotropic_gaussian_proposal(1.0),
    jnp.asarray(mm.init_det(4, 2), jnp.float64),
).seed(42)
s = mh.run(500, 100)
assert s.dtype == jnp.float64, s.dtype
assert abs(float(jnp.mean(s))) < 0.3

h = mm.HMC(rosenbrock_nd(), jnp.asarray(mm.init_det(4, 3), jnp.float64),
           0.05, 8).seed(1)
sh = h.run(200, 100)
assert sh.dtype == jnp.float64, sh.dtype
rhat, ess = mm.split_rhat_mean_ess(sh)
assert np.all(np.isfinite(np.asarray(rhat)))

# MALA + the dual-averaging tuner: the adaptation scan must carry f64
# scalars when the state is f64 (ops/adapt.py dtype handling)
ml = mm.MALA(rosenbrock_nd(), jnp.asarray(mm.init_det(4, 3), jnp.float64),
             step_size=0.5).seed(4).tuned(100)
sm = ml.run(200, 50)
assert sm.dtype == jnp.float64, sm.dtype
assert np.isfinite(float(jnp.mean(sm)))

ss = mm.SliceSampler(t, jnp.asarray(mm.init_det(4, 2), jnp.float64)).seed(2)
s2 = ss.run(300, 50)
assert s2.dtype == jnp.float64, s2.dtype
assert abs(float(jnp.mean(s2))) < 0.3

from mini_mcmc_tpu.models.base import Target
lik = Target(logp=lambda x: -0.5 * jnp.sum((x - 1.0) ** 2))
es = mm.EllipticalSliceSampler(
    lik, jnp.asarray(mm.init_det(4, 2), jnp.float64)).seed(3)
s3 = es.run(300, 50)
assert s3.dtype == jnp.float64, s3.dtype
assert abs(float(jnp.mean(s3)) - 0.5) < 0.25

# SGLD/SGHMC: the carry dtype follows the f64 positions even though the
# noise/schedule constants are written as f32-friendly literals
from mini_mcmc_tpu.ops.sgmcmc import target_grad
g = target_grad(t)
sg = mm.SGLD(g, jnp.asarray(mm.init_det(4, 2), jnp.float64),
             step_size=mm.polynomial_decay(5e-2, 10.0, 0.55)).seed(5)
s4 = sg.run(300, 100)
assert s4.dtype == jnp.float64, s4.dtype
assert abs(float(jnp.mean(s4))) < 0.3
sh2 = mm.SGHMC(g, jnp.asarray(mm.init_det(4, 2), jnp.float64),
               step_size=0.05, friction=0.1).seed(6)
s5 = sh2.run(300, 100)
assert s5.dtype == jnp.float64, s5.dtype
assert abs(float(jnp.mean(s5))) < 0.35
print("OK")
"""


def test_float64_kernels_subprocess():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=_REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout
