"""Hierarchical 8-schools model with NUTS — centered vs non-centered.

The classic hierarchical Bayesian posterior (Rubin 1981; Stan manual):

    y_j ~ N(theta_j, sigma_j^2)      j = 1..8   (observed effects + SEs)
    theta_j ~ N(mu, tau^2)                      (school effects)
    mu ~ N(0, 5^2),  tau ~ HalfCauchy(5)        (hyperpriors)

Beyond the reference's synthetic targets in two ways:

- **Funnel geometry**: the centered parameterization (sampling theta
  directly) has the Neal's-funnel pathology — NUTS reports divergences,
  surfaced here through ``sampler.divergences`` exactly the way a
  practitioner would detect the problem. Reparameterizing non-centered
  (theta = mu + tau * eta, eta ~ N(0,1)) removes it.
- **Exact ground truth**: conditioning on tau makes the model Gaussian, so
  theta and mu integrate out in closed form and the tau marginal is a 1-D
  quadrature — the posterior means asserted below are exact, not MCMC-vs-
  MCMC. (Same self-validation pattern as bench.py's Rosenbrock moments.)

Sampling happens in unconstrained coordinates (log tau, with the Jacobian
term in the log density) — the standard change-of-variables treatment the
reference never needs because its targets are all unconstrained.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mini_mcmc_tpu import NUTS, init_with_seed, run_stats
from mini_mcmc_tpu.models.base import Target

# Rubin (1981) data: estimated treatment effects and standard errors.
Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], np.float32)
SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], np.float32)
MU_PRIOR_STD = 5.0
TAU_PRIOR_SCALE = 5.0


def _log_half_cauchy(tau):
    return (jnp.log(2.0 / (jnp.pi * TAU_PRIOR_SCALE))
            - jnp.log1p((tau / TAU_PRIOR_SCALE) ** 2))


def make_noncentered_target():
    """params = [mu, log_tau, eta_1..8] (D=10), theta = mu + tau * eta.

    Also carries the chains-on-lanes ``logp_dc``/``grad_dc`` forms
    (rows = parameters, lanes = chains; Python-float data constants,
    elementwise ops only) — the template for writing them for a user
    model. ``logp_dc`` alone would suffice (``Target.dc_forms()`` derives
    the gradient by AD); the hand-written ``grad_dc`` here is the optional
    optimization for densities whose value and gradient share
    subexpressions, pinned against autodiff of ``logp_batch`` in
    ``tests/test_examples.py``.
    """
    y, sig = jnp.asarray(Y), jnp.asarray(SIGMA)

    def logp_batch(params):  # [C, 10] -> [C]
        mu, log_tau, eta = params[:, :1], params[:, 1:2], params[:, 2:]
        tau = jnp.exp(log_tau)
        theta = mu + tau * eta  # [C, 8]
        loglik = -0.5 * jnp.sum(((y - theta) / sig) ** 2, axis=1)
        logp_eta = -0.5 * jnp.sum(eta * eta, axis=1)
        logp_mu = -0.5 * (mu[:, 0] / MU_PRIOR_STD) ** 2
        # + log_tau: Jacobian of tau = exp(log_tau)
        logp_tau = _log_half_cauchy(tau[:, 0]) + log_tau[:, 0]
        return loglik + logp_eta + logp_mu + logp_tau

    # Host-float constants: the dc forms use elementwise / broadcast jnp
    # ops on the lane arrays only, with the data baked in as Python
    # floats.
    yf = [float(v) for v in Y]
    sf2 = [float(v) ** 2 for v in SIGMA]
    log_hc = float(np.log(2.0 / (np.pi * TAU_PRIOR_SCALE)))

    def logp_dc(p):  # [10, ...] -> [...]
        mu, log_tau = p[0], p[1]
        tau = jnp.exp(log_tau)
        acc = -0.5 * (mu / MU_PRIOR_STD) ** 2
        acc = acc + log_hc - jnp.log1p((tau / TAU_PRIOR_SCALE) ** 2)
        acc = acc + log_tau
        for j in range(8):
            eta = p[2 + j]
            theta = mu + tau * eta
            acc = acc - 0.5 * (yf[j] - theta) ** 2 / sf2[j]
            acc = acc - 0.5 * eta * eta
        return acc

    def grad_dc(p):  # [10, ...] -> [10, ...]
        mu, log_tau = p[0], p[1]
        tau = jnp.exp(log_tau)
        g_mu = -mu / MU_PRIOR_STD**2
        t2 = (tau / TAU_PRIOR_SCALE) ** 2
        g_lt = 1.0 - 2.0 * t2 / (1.0 + t2)
        rows_eta = []
        for j in range(8):
            eta = p[2 + j]
            r = (yf[j] - (mu + tau * eta)) / sf2[j]
            g_mu = g_mu + r
            g_lt = g_lt + r * tau * eta
            rows_eta.append((r * tau - eta)[None])
        return jnp.concatenate([g_mu[None], g_lt[None]] + rows_eta, axis=0)

    return Target(
        logp=lambda p: logp_batch(p[None, :])[0], logp_batch=logp_batch,
        logp_dc=logp_dc, grad_dc=grad_dc,
    )


def make_centered_target():
    """params = [mu, log_tau, theta_1..8] — the funnel parameterization."""
    y, sig = jnp.asarray(Y), jnp.asarray(SIGMA)

    def logp_batch(params):  # [C, 10] -> [C]
        mu, log_tau, theta = params[:, :1], params[:, 1:2], params[:, 2:]
        tau = jnp.exp(log_tau)
        loglik = -0.5 * jnp.sum(((y - theta) / sig) ** 2, axis=1)
        logp_theta = (-0.5 * jnp.sum(((theta - mu) / tau) ** 2, axis=1)
                      - 8.0 * log_tau[:, 0])
        logp_mu = -0.5 * (mu[:, 0] / MU_PRIOR_STD) ** 2
        logp_tau = _log_half_cauchy(tau[:, 0]) + log_tau[:, 0]
        return loglik + logp_theta + logp_mu + logp_tau

    return Target(
        logp=lambda p: logp_batch(p[None, :])[0], logp_batch=logp_batch
    )


def exact_posterior_means():
    """E[mu | y] and E[tau | y] by 1-D quadrature over the tau marginal.

    Given tau, integrating theta out gives y_j ~ N(mu, sigma_j^2 + tau^2);
    integrating mu out against its N(0, s^2) prior is another Gaussian
    integral. Both are closed-form, leaving p(tau | y) on a grid.
    """
    tau = np.linspace(1e-4, 80.0, 200_000)
    v = SIGMA[None, :].astype(np.float64) ** 2 + tau[:, None] ** 2  # [T, 8]
    a = np.sum(1.0 / v, axis=1) + 1.0 / MU_PRIOR_STD**2
    b = np.sum(Y[None, :] / v, axis=1)
    log_lik = (-0.5 * np.sum(np.log(v) + Y[None, :] ** 2 / v, axis=1)
               - 0.5 * np.log(a) + 0.5 * b * b / a)
    log_prior = -np.log1p((tau / TAU_PRIOR_SCALE) ** 2)
    w = np.exp(log_lik + log_prior - np.max(log_lik + log_prior))
    w /= np.sum(w)
    return float(np.sum(w * b / a)), float(np.sum(w * tau))


def main(n_chains=32, n_collect=1000, n_discard=500):
    exact_mu, exact_tau = exact_posterior_means()
    print(f"exact:        E[mu]={exact_mu:.3f}  E[tau]={exact_tau:.3f}")

    # Two runs each, bench.py-style: the first adapts (epsilon search +
    # dual averaging) and burns in; the second is the steady state, whose
    # per-run divergence delta (``last_run_divergences``) is the honest
    # geometry diagnostic — the cumulative ``divergences`` counter is
    # dominated by the expected pre-adaptation transient.
    def run_twice(target, chains, seed):
        s = NUTS(target, init_with_seed(chains, 10, seed=seed), 0.8).seed(seed)
        s.run(n_collect, n_discard)
        sample = s.run(n_collect, n_discard)
        steps = chains * (n_collect + n_discard)
        # executed-leapfrog accounting: the lockstep cost per draw (every
        # chain pays the deepest tree; one gradient eval per leapfrog)
        lf_per_draw = float(s.last_run_leapfrogs[0]) / (
            n_collect + n_discard - 1)
        print(f"    ({lf_per_draw:.0f} leapfrog grad evals per draw, "
              "lockstep)")
        return sample, int(jnp.sum(s.last_run_divergences)) / steps

    # Non-centered: clean geometry, exact-moment recovery.
    sample, rate_nc = run_twice(make_noncentered_target(), n_chains, seed=3)
    flat = np.asarray(sample).reshape(-1, 10)
    mu_hat = float(flat[:, 0].mean())
    tau_hat = float(np.exp(flat[:, 1]).mean())
    print(f"non-centered: E[mu]={mu_hat:.3f}  E[tau]={tau_hat:.3f}  "
          f"steady-state divergence rate={rate_nc:.2%}")
    print(run_stats(sample))
    from mini_mcmc_tpu import rank_normalized_diagnostics, summary

    modern = rank_normalized_diagnostics(sample)
    print(modern)
    # the one-stop per-parameter report for the interesting coordinates
    print(summary(sample[:, :, :2], param_names=("mu", "log_tau")))

    # Centered: same posterior, funnel geometry — the per-run divergence
    # delta (the reference's nuts.rs:807 check, surfaced per sampler run)
    # stays high AFTER adaptation, which is the practitioner's signal to
    # reparameterize or raise target_accept_p.
    _, rate_cen = run_twice(make_centered_target(), 16, seed=5)
    print(f"centered:     steady-state divergence rate={rate_cen:.2%} "
          "(funnel geometry)")

    # Exact-moment gates (quadrature ground truth, generous MCSE margin).
    assert abs(mu_hat - exact_mu) < 0.3, (mu_hat, exact_mu)
    assert abs(tau_hat - exact_tau) < 0.5, (tau_hat, exact_tau)
    assert float(jnp.max(modern.rhat)) < 1.05
    assert rate_nc < 0.005, rate_nc  # non-centered: clean steady state
    return mu_hat, tau_hat


if __name__ == "__main__":
    main()
