"""Evaluation metrics."""

from .metrics import ate_rmse, mean_reprojection_error

__all__ = ["ate_rmse", "mean_reprojection_error"]
