"""Pixel <-> meter linear conversions.

A copy of ``padel_analytics_tpu/utils/conversions.py`` (the reference's
utils/conversions.py), including the int() truncation of the meters->pixels
direction, which the minimap layout depends on.
"""


def convert_pixel_distance_to_meters(
    pixel_distance: float,
    reference_in_meters: float,
    reference_in_pixels: float,
) -> float:
    return (pixel_distance * reference_in_meters) / reference_in_pixels


def convert_meters_to_pixel_distance(
    meters: float,
    reference_in_meters: float,
    reference_in_pixels: float,
) -> int:
    return int((meters * reference_in_pixels) / reference_in_meters)
