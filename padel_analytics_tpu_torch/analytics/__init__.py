"""Court projection, the per-player kinematics table (data.csv) and the
ball's velocity between two frames (velocity_estimator)."""

from .data_analytics import DataAnalytics, DataPoint, PlayerPosition
from .projected_court import ProjectedCourt, ProjectedCourtKeypoints, Rectangle

__all__ = [
    "DataAnalytics",
    "DataPoint",
    "PlayerPosition",
    "ProjectedCourt",
    "ProjectedCourtKeypoints",
    "Rectangle",
]
