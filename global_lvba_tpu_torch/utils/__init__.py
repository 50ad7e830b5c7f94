from .logging import get_logger, setup_logging
from .progress import progress_bar
from .metrics import StageTimer, MetricsRegistry
from .checkpoint import StageCheckpoint
from .robust import (
    compute_mad,
    pick_largest_cluster_as_inliers,
    preprocess_low_texture_bgr,
)

__all__ = [
    "get_logger",
    "setup_logging",
    "progress_bar",
    "StageTimer",
    "MetricsRegistry",
    "StageCheckpoint",
    "compute_mad",
    "pick_largest_cluster_as_inliers",
    "preprocess_low_texture_bgr",
]
