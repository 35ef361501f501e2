"""Fairness engine of the port: EDDI and Equalized-Odds metrics and the
differentiable L_EDDI loss, under the JAX ``fairmultimodal_tpu.fairness``
names."""

from fairmultimodal_torch.fairness.eddi import (
    combined_eddi,
    compute_eddi,
    eddi_from_stats,
    subgroup_error_stats,
)
from fairmultimodal_torch.fairness.eo import equalized_odds, equalized_odds_pairwise, tpr_fpr
from fairmultimodal_torch.fairness.loss import eddi_loss, subgroup_soft_errors

__all__ = [
    "compute_eddi",
    "combined_eddi",
    "subgroup_error_stats",
    "eddi_from_stats",
    "tpr_fpr",
    "equalized_odds",
    "equalized_odds_pairwise",
    "eddi_loss",
    "subgroup_soft_errors",
]
