"""Plain-tensor ops and the hand-written kernels (K1 conv3x3, K2 heatmap decode)."""

from .association_scan import associate_clip

__all__ = ["associate_clip"]
