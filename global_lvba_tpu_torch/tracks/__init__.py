"""Match-graph tracks."""

from .build import TrackSet, build_components

__all__ = ["build_components", "TrackSet"]
