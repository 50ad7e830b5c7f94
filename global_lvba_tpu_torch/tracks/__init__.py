"""Match-graph tracks and their 3D fusion."""

from .build import TrackSet, build_components
from .fuse import FuseResult, fuse_tracks

__all__ = ["build_components", "TrackSet", "fuse_tracks", "FuseResult"]
