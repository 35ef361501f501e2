"""Fairness engine of the port: the differentiable L_EDDI loss and EDDI."""
