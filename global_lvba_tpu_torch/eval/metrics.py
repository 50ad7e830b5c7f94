"""Evaluation metrics: ATE and reprojection error (port of
global_lvba_tpu.eval.metrics).

These are the parity metrics of the reference (SURVEY.md §6): the global
mean pre/post reprojection error it prints (src/lvba_system.cpp:1830-1833)
and the trajectory accuracy."""

from __future__ import annotations

import numpy as np
import torch

from ..factors.reprojection import reproj_residuals_batch
from ..models.synthetic import ate_rmse  # re-export (Umeyama-aligned RMSE)

__all__ = ["ate_rmse", "mean_reprojection_error"]


def mean_reprojection_error(cam, Rcw, tcw, X, obs_cam, obs_pt,
                            obs_uv) -> float:
    """Global mean pixel reprojection error over observations, per-image
    mean first, then the mean over images (visualizeProj,
    lvba_system.cpp:1784-1833).  A host metric: float64 on the CPU, from
    numpy arrays or tensors on any device."""
    def f64(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to("cpu", torch.float64)
        return torch.as_tensor(np.asarray(a, np.float64))

    r = reproj_residuals_batch(
        cam, f64(Rcw), f64(tcw), f64(X),
        torch.as_tensor(np.asarray(obs_cam, np.int64)),
        torch.as_tensor(np.asarray(obs_pt, np.int64)), f64(obs_uv), 1.0)
    err = np.linalg.norm(r.numpy(), axis=-1)
    oc = np.asarray(obs_cam)
    return float(np.mean([err[oc == c].mean() for c in np.unique(oc)]))
