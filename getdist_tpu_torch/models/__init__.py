"""Analytic distribution models (the framework's "model families"):
Gaussian mixtures used as truth distributions and sample generators
(re-exported from gaussian_mixtures), plus Fisher-matrix forecasting
helpers (:mod:`getdist_tpu_torch.models.fisher`)."""

from getdist_tpu_torch.gaussian_mixtures import (
    Gaussian1D,
    Gaussian2D,
    GaussianND,
    Mixture1D,
    Mixture2D,
    MixtureND,
    RandomTestMixtureND,
    randomTestMCSamples,
)
from getdist_tpu_torch.models.fisher import (
    combine_fishers,
    condition_fisher,
    confidence_ellipse,
    figure_of_merit,
    fisher_sigma,
    fisher_to_cov,
    gaussian_from_fisher,
    marginalize_fisher,
)

__all__ = [
    "Gaussian1D",
    "Gaussian2D",
    "GaussianND",
    "Mixture1D",
    "Mixture2D",
    "MixtureND",
    "RandomTestMixtureND",
    "randomTestMCSamples",
    "combine_fishers",
    "condition_fisher",
    "confidence_ellipse",
    "figure_of_merit",
    "fisher_sigma",
    "fisher_to_cov",
    "gaussian_from_fisher",
    "marginalize_fisher",
]
