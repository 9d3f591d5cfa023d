"""Plain-tensor ops and the hand-written kernels (K1 conv3x3, K2 heatmap decode).

The JAX package's ``ops`` exports, from the port's modules. Its
``decode_heatmaps_pallas`` is the TPU kernel's own name and has no alias:
`decode_heatmaps` launches kernel K2 for a CUDA tensor. Importing this
package builds and loads no kernel (each wrapper does so at its first
launch) and imports neither OpenCV nor Triton.
"""

from .association import ByteTrack
from .association_scan import associate_clip
from .ensemble import get_ensemble_weight, overlap_ensemble_coefficients
from .heatmap import decode_heatmaps
from .homography import find_homography, project_points
from .median import median_background
from .nms import batched_nms
from .polygon import PolygonZone
from .resize import (
    ResizePlan,
    cv2_bilinear_matrix,
    letterbox_plan,
    pil_resample_matrix,
    resize_plan,
)

__all__ = [
    "ResizePlan",
    "cv2_bilinear_matrix",
    "letterbox_plan",
    "pil_resample_matrix",
    "resize_plan",
    "find_homography",
    "project_points",
    "PolygonZone",
    "batched_nms",
    "decode_heatmaps",
    "get_ensemble_weight",
    "overlap_ensemble_coefficients",
    "median_background",
    "ByteTrack",
    "associate_clip",
]
