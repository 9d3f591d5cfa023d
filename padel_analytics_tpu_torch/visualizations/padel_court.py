"""2-D padel-court figures (meters, -5..5 x -10..10).

Counterpart of ``padel_analytics_tpu/visualizations/padel_court.py``, with
the reference's geometry: baselines at y=+-10 (heavy), service lines at
y=+-7, dashed net at y=0, side walls at x=+-5, the center service line
between the service lines. plotly (the reference's renderer) and
matplotlib are imported inside the functions that draw: `padel_court_2d`
raises ImportError where plotly is absent, and `padel_court_segments`
gives the raw line list to any renderer.
"""

from __future__ import annotations

import io

import numpy as np


def padel_court_segments():
    """(x0, y0, x1, y1, heavy) court line segments in meters."""
    return [
        (-5, -10, 5, -10, True),  # near baseline
        (-5, -7, 5, -7, False),  # near service line
        (-5, 0, 5, 0, False),  # net (dashed)
        (-5, 7, 5, 7, False),  # far service line
        (-5, 10, 5, 10, True),  # far baseline
        (-5, -10, -5, 10, True),  # left wall
        (0, -7, 0, 7, False),  # center service line
        (5, -10, 5, 10, True),  # right wall
    ]


def padel_court_2d(width: int = 400):
    """Plotly figure of the court."""
    try:
        import plotly.graph_objects as go
    except ImportError as e:
        raise ImportError("plotly is not installed; use padel_court_2d_matplotlib()") from e
    height = width * 2
    fig = go.Figure()
    for x0, y0, x1, y1, heavy in padel_court_segments():
        dash = "dash" if (y0 == 0 and y1 == 0) else None
        fig.add_trace(
            go.Scatter(
                x=[x0, x1],
                y=[y0, y1],
                mode="lines",
                line=dict(color="gray", width=8 if heavy else 2, dash=dash),
            )
        )
    fig.update_layout(
        xaxis=dict(showgrid=False, title="Base Line", tick0=-5, dtick=1, range=[-5, 5]),
        yaxis=dict(showgrid=False, title="Side Line", tick0=-10, dtick=2),
        showlegend=False,
        height=height,
        width=width,
    )
    return fig


def padel_court_2d_matplotlib(width_inches: float = 4.0):
    """The same geometry with matplotlib (Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(width_inches, width_inches * 2))
    for x0, y0, x1, y1, heavy in padel_court_segments():
        style = "--" if (y0 == 0 and y1 == 0) else "-"
        ax.plot([x0, x1], [y0, y1], style, color="gray", lw=4 if heavy else 1)
    ax.set_xlim(-5.5, 5.5)
    ax.set_ylim(-10.5, 10.5)
    ax.set_xlabel("Base Line")
    ax.set_ylabel("Side Line")
    return fig, ax


def plotly_fig2array(fig) -> np.ndarray:
    """Plotly figure -> numpy image."""
    from PIL import Image

    fig_bytes = fig.to_image(format="png")
    return np.asarray(Image.open(io.BytesIO(fig_bytes)))


def matplotlib_fig2array(fig) -> np.ndarray:
    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=100)
    buf.seek(0)
    return np.asarray(Image.open(buf))
