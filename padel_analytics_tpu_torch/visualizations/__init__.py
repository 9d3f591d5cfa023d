"""2-D padel-court figures (plotly and matplotlib, both imported lazily)."""

from .padel_court import padel_court_2d, padel_court_2d_matplotlib

__all__ = ["padel_court_2d", "padel_court_2d_matplotlib"]
