"""Court projection and the per-player kinematics table (data.csv)."""

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
