"""Image datatype converters (numpy / PIL / base64).

A copy of ``padel_analytics_tpu/utils/converters.py`` (the reference's
utils/converters.py); PIL is imported where a conversion needs it.
"""

from __future__ import annotations

import base64
import io

import numpy as np


def numpy_to_pil(image_array: np.ndarray):
    from PIL import Image

    return Image.fromarray(image_array.astype("uint8"))


def numpy_to_base64(image_array: np.ndarray) -> str:
    image_pil = numpy_to_pil(image_array)
    stream = io.BytesIO()
    image_pil.save(stream, format="PNG")
    return base64.b64encode(stream.getvalue()).decode("utf-8")


def pil_to_numpy(image_pil) -> np.ndarray:
    return np.asarray(image_pil)


def base64_to_pil(image_b64: str):
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(image_b64)))


def base64_to_numpy(image_b64: str) -> np.ndarray:
    return pil_to_numpy(base64_to_pil(image_b64))
