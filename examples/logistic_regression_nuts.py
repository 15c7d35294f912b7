"""Bayesian logistic regression with NUTS — a realistic posterior.

Beyond the reference's synthetic targets: the log posterior of logistic
regression over a design matrix is a single ``[C, D] @ [D, N]`` matmul per
evaluation, which XLA hands to the matmul units — the shape of real
production MCMC workloads on an accelerator. Demonstrates a custom
``Target`` with a fused batched form and analytic gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mini_mcmc_tpu import NUTS, init_det, run_stats
from mini_mcmc_tpu.models.base import Target


def make_logistic_target(X, y, prior_std=10.0):
    """Log posterior of logistic regression: Bernoulli likelihood with a
    N(0, prior_std^2) prior on the weights."""
    X = jnp.asarray(X)
    y = jnp.asarray(y)
    inv_prior_var = 1.0 / (prior_std * prior_std)

    def logp(beta):
        z = X @ beta  # [N]
        # sum_i [y_i z_i - softplus(z_i)] — numerically stable Bernoulli
        loglik = jnp.sum(y * z - jax.nn.softplus(z))
        return loglik - 0.5 * inv_prior_var * jnp.sum(beta * beta)

    def logp_batch(betas):  # [C, D]
        z = betas @ X.T  # [C, N] — MXU matmul
        loglik = jnp.sum(y[None, :] * z - jax.nn.softplus(z), axis=1)
        return loglik - 0.5 * inv_prior_var * jnp.sum(betas * betas, axis=1)

    def grad(beta):
        z = X @ beta
        resid = y - jax.nn.sigmoid(z)  # [N]
        return X.T @ resid - inv_prior_var * beta

    return Target(logp=logp, logp_batch=logp_batch, grad=grad)


def main(n_points=256, dim=4, seed=0):
    # synthetic data from known weights
    key = jax.random.PRNGKey(seed)
    k_x, k_y = jax.random.split(key)
    true_beta = jnp.asarray(np.linspace(-1.5, 1.5, dim), jnp.float32)
    X = jax.random.normal(k_x, (n_points, dim), jnp.float32)
    p = jax.nn.sigmoid(X @ true_beta)
    y = (jax.random.uniform(k_y, (n_points,)) < p).astype(jnp.float32)

    target = make_logistic_target(X, y)
    sampler = NUTS(target, init_det(4, dim), 0.8).seed(42)
    sample = sampler.run(1000, 500)

    post_mean = np.asarray(sample).reshape(-1, dim).mean(axis=0)
    print("true beta:     ", np.asarray(true_beta))
    print("posterior mean:", post_mean)
    print(run_stats(sample))
    # modern (beyond-reference) diagnostics: rank-normalized R-hat,
    # bulk/tail ESS (diagnostics.py, Vehtari et al. 2021)
    from mini_mcmc_tpu import rank_normalized_diagnostics

    print(rank_normalized_diagnostics(sample))
    print("divergences:", int(jnp.sum(sampler.divergences)))

    # parameter recovery within posterior uncertainty
    post_std = np.asarray(sample).reshape(-1, dim).std(axis=0)
    assert np.all(np.abs(post_mean - np.asarray(true_beta)) < 4 * post_std + 0.5)
    return post_mean


if __name__ == "__main__":
    main()
