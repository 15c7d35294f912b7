"""Target distributions, proposals and conditionals (the reference's
``distributions`` module, /root/reference/src/distributions.rs)."""

from .base import (
    Conditional,
    Proposal,
    Target,
    derive_grad_dc,
    derive_logp_dc,
    validate_dc_forms,
)
from .discrete import (
    Categorical,
    binomial_target,
    poisson_target,
    random_walk_int_proposal,
)
from .gaussian import (
    diffable_gaussian2d,
    gaussian2d,
    gaussian_random_walk_proposal,
    isotropic_gaussian_proposal,
    isotropic_gaussian_target,
    neal_funnel,
    standard_normal,
)
from .mixture import constant_conditional, gaussian_mixture_conditional
from .precondition import (
    Preconditioner,
    estimate_preconditioner,
    precondition_target,
)
from .rosenbrock import rosenbrock2d, rosenbrock_nd
from .transforms import (
    Bijector,
    CoordinateTransform,
    identity,
    interval,
    lower_bounded,
    positive,
    transformed_target,
    upper_bounded,
)

__all__ = [
    "Bijector",
    "Categorical",
    "Conditional",
    "CoordinateTransform",
    "Preconditioner",
    "Proposal",
    "Target",
    "identity",
    "interval",
    "lower_bounded",
    "positive",
    "transformed_target",
    "upper_bounded",
    "derive_grad_dc",
    "derive_logp_dc",
    "validate_dc_forms",
    "estimate_preconditioner",
    "precondition_target",
    "binomial_target",
    "constant_conditional",
    "diffable_gaussian2d",
    "gaussian2d",
    "gaussian_mixture_conditional",
    "gaussian_random_walk_proposal",
    "isotropic_gaussian_proposal",
    "isotropic_gaussian_target",
    "neal_funnel",
    "poisson_target",
    "random_walk_int_proposal",
    "rosenbrock2d",
    "rosenbrock_nd",
    "standard_normal",
]
