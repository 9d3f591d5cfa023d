"""Point-in-polygon gating for on-court player filtering.

Counterpart of ``padel_analytics_tpu/ops/polygon.py``: the reference checks
each detection's bottom-centre anchor against a cv2.fillPoly mask of the
court polygon (supervision's PolygonZone); here it is an analytic
crossing-number test over tensors, which agrees with the rasterised mask
for interior points and differs only on boundary-adjacent subpixels.

The test runs in float64: points are promoted to it, and the polygon is
kept in it. The JAX package's tests run its version in float64 too (they
enable x64), so a point exactly as far from an edge as float32 rounding can
move it lands on the same side in both.
"""

from __future__ import annotations

import numpy as np
import torch


def points_in_polygon(points: torch.Tensor, polygon: torch.Tensor) -> torch.Tensor:
    """Even-odd (crossing number) point-in-polygon test in float64.

    points: (..., 2); polygon: (V, 2). Returns bool (...). Points exactly on
    a horizontal edge follow the half-open rule (as rasterisation does)."""
    points = points.double()
    polygon = polygon.to(device=points.device, dtype=torch.float64)
    px = points[..., 0:1]
    py = points[..., 1:2]
    x0, y0 = polygon[:, 0], polygon[:, 1]
    x1, y1 = torch.roll(x0, -1), torch.roll(y0, -1)

    # Edge straddles the horizontal ray through py.
    cond = (y0 > py) != (y1 > py)
    # x coordinate where the edge crosses the ray.
    denom = torch.where(y1 - y0 == 0, torch.ones_like(y0), y1 - y0)
    x_cross = x0 + (py - y0) * (x1 - x0) / denom
    crossings = torch.sum(cond & (px < x_cross), dim=-1)
    return (crossings % 2) == 1


def bottom_centers(xyxy: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy boxes -> (..., 2) bottom-centre anchors."""
    return torch.stack([(xyxy[..., 0] + xyxy[..., 2]) / 2.0, xyxy[..., 3]], dim=-1)


class PolygonZone:
    """Polygon gate with a supervision-compatible trigger() surface (the
    reference builds it from court keypoints 0, 1, -1, -2)."""

    def __init__(self, polygon: np.ndarray, frame_resolution_wh=None):
        self.polygon = np.asarray(polygon, dtype=np.float64)
        self.frame_resolution_wh = frame_resolution_wh

    def trigger_xyxy(self, xyxy: torch.Tensor) -> torch.Tensor:
        """Bottom-centre anchors of (..., 4) xyxy boxes inside the polygon."""
        anchors = bottom_centers(xyxy)
        if self.frame_resolution_wh is not None:
            w, h = self.frame_resolution_wh
            anchors = torch.stack([anchors[..., 0].clamp(0, w), anchors[..., 1].clamp(0, h)],
                                  dim=-1)
        return points_in_polygon(anchors, torch.from_numpy(self.polygon))

    def trigger(self, xyxy: np.ndarray) -> np.ndarray:
        """Host-side mirror of sv.PolygonZone.trigger."""
        return self.trigger_xyxy(torch.as_tensor(np.asarray(xyxy))).numpy()
