"""Robust GP regression via elliptical slice sampling.

Beyond-reference capability demo (the Rust reference has no elliptical
slice sampler and no latent-Gaussian machinery): infer a latent Gaussian
process under a heavy-tailed Student-t likelihood — the standard cure for
outliers that silently wreck the Gaussian-likelihood (conjugate) GP fit.

The posterior is p(f | y) ∝ N(f; 0, K) * Π_i t_ν(y_i − f_i), exactly the
shape ``EllipticalSliceSampler`` is built for: the GP prior enters through
the ellipse construction (one batched ``[C, D] @ [D, D]`` Cholesky matmul
per step), the Student-t likelihood through the accept
test, and there is nothing to tune.

The comparison: the analytic Gaussian-likelihood GP posterior mean gets
dragged toward the outliers; the Student-t posterior mean (from sampling)
shrugs them off. RMSE against the true latent function, side by side.
"""

import jax
import jax.numpy as jnp

from mini_mcmc_tpu import (
    EllipticalSliceSampler,
    split_rhat_mean_ess,
)
from mini_mcmc_tpu.models.base import Target

N_POINTS = 48
NOISE_STD = 0.15
NU = 3.0  # Student-t degrees of freedom


def rbf_kernel(x, lengthscale=0.6, amplitude=1.0):
    d2 = (x[:, None] - x[None, :]) ** 2
    return amplitude**2 * jnp.exp(-0.5 * d2 / lengthscale**2)


def student_t_loglik(resid, nu, scale):
    z2 = (resid / scale) ** 2
    return jnp.sum(-0.5 * (nu + 1.0) * jnp.log1p(z2 / nu))


def main():
    # -- synthetic data with outliers ------------------------------------
    x = jnp.linspace(-3.0, 3.0, N_POINTS)
    kmat = rbf_kernel(x) + 1e-6 * jnp.eye(N_POINTS)
    chol = jnp.linalg.cholesky(kmat)
    key = jax.random.PRNGKey(0)
    k_f, k_eps = jax.random.split(key)
    f_true = chol @ jax.random.normal(k_f, (N_POINTS,))
    y = f_true + NOISE_STD * jax.random.normal(k_eps, (N_POINTS,))
    # plant three gross outliers
    y = y.at[jnp.array([7, 23, 40])].add(jnp.array([4.0, -5.0, 4.5]))

    # -- analytic Gaussian-likelihood GP fit (outlier-sensitive) ---------
    gauss_post_mean = kmat @ jnp.linalg.solve(
        kmat + NOISE_STD**2 * jnp.eye(N_POINTS), y
    )

    # -- Student-t likelihood posterior via elliptical slice -------------
    loglik = Target(
        logp=lambda f: student_t_loglik(y - f, NU, NOISE_STD)
    )
    n_chains = 24
    init = 0.01 * jax.random.normal(
        jax.random.PRNGKey(1), (n_chains, N_POINTS)
    )
    es = EllipticalSliceSampler(loglik, init, prior_scale=chol).seed(2)
    sample = es.run(1200, 300)
    robust_post_mean = jnp.asarray(sample).reshape(-1, N_POINTS).mean(axis=0)

    rhat, ess = split_rhat_mean_ess(sample)
    rmse_gauss = float(jnp.sqrt(jnp.mean((gauss_post_mean - f_true) ** 2)))
    rmse_robust = float(jnp.sqrt(jnp.mean((robust_post_mean - f_true) ** 2)))

    print(f"latent GP, {N_POINTS} points, 3 planted outliers, "
          f"Student-t(nu={NU}) likelihood")
    print(f"Gaussian-likelihood GP RMSE vs truth: {rmse_gauss:.3f}  "
          "(outliers drag the conjugate fit)")
    print(f"Student-t (elliptical slice) RMSE:    {rmse_robust:.3f}")
    print(f"max split R-hat {float(jnp.max(rhat)):.3f}, "
          f"min ESS {float(jnp.min(ess)):.0f} "
          f"({n_chains} chains x 1200 draws)")
    assert rmse_robust < rmse_gauss, "robust fit should beat conjugate here"


if __name__ == "__main__":
    main()
