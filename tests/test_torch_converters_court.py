"""The port's image converters and court figures against the JAX package's:

- utils/converters.py: base64 strings equal to the JAX package's, and the
  round trips numpy -> base64 -> numpy / PIL exact (PNG is lossless);
- visualizations/padel_court.py: the segments equal, the matplotlib figure
  rendered to the same pixels (matplotlib_fig2array), and plotly imported
  only when a plotly figure is asked for: where it is absent the call
  raises ImportError, the import of the module does not; with a stand-in
  plotly the figure gets the court's 8 traces and the reference's layout.
"""

import importlib
import sys
from unittest import mock

import numpy as np
import pytest

from padel_analytics_tpu.utils import converters as jax_conv
from padel_analytics_tpu.visualizations import padel_court as jax_court
from padel_analytics_tpu_torch.utils import converters as conv
from padel_analytics_tpu_torch.visualizations import padel_court as court


@pytest.mark.parametrize("shape", [(17, 23, 3), (8, 5), (4, 6, 4)])
def test_base64_equals_jax(rng, shape):
    image = rng.integers(0, 256, shape).astype(np.float64)  # astype('uint8') in both
    b64 = conv.numpy_to_base64(image)
    assert b64 == jax_conv.numpy_to_base64(image)
    back = conv.base64_to_numpy(b64)
    np.testing.assert_array_equal(back, image.astype(np.uint8))
    np.testing.assert_array_equal(back, jax_conv.base64_to_numpy(b64))
    pil = conv.base64_to_pil(b64)
    assert (pil.mode, pil.size) == (jax_conv.base64_to_pil(b64).mode, (shape[1], shape[0]))
    np.testing.assert_array_equal(conv.pil_to_numpy(conv.numpy_to_pil(image)),
                                  jax_conv.pil_to_numpy(jax_conv.numpy_to_pil(image)))


def test_court_segments_equal_jax():
    assert court.padel_court_segments() == jax_court.padel_court_segments()


def test_matplotlib_court_equals_jax():
    import matplotlib.pyplot as plt

    fig, ax = court.padel_court_2d_matplotlib(3.0)
    jfig, jax_ax = jax_court.padel_court_2d_matplotlib(3.0)
    try:
        assert (ax.get_xlim(), ax.get_ylim(), ax.get_xlabel(), ax.get_ylabel()) == \
            (jax_ax.get_xlim(), jax_ax.get_ylim(), jax_ax.get_xlabel(), jax_ax.get_ylabel())
        got = court.matplotlib_fig2array(fig)
        want = jax_court.matplotlib_fig2array(jfig)
        assert got.shape == (600, 300, 4)
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got.reshape(-1, 4), axis=0)) > 2  # lines were drawn
    finally:
        plt.close(fig)
        plt.close(jfig)


def test_plotly_absent_raises_at_call_not_import(monkeypatch):
    monkeypatch.setitem(sys.modules, "plotly", None)
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", None)
    module = importlib.reload(court)  # imports without plotly
    with pytest.raises(ImportError, match="plotly"):
        module.padel_court_2d()


def test_plotly_court_with_a_stand_in(monkeypatch):
    plotly = mock.MagicMock(name="plotly")
    monkeypatch.setitem(sys.modules, "plotly", plotly)
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", plotly.graph_objects)
    fig = court.padel_court_2d(width=300)
    go = plotly.graph_objects
    assert fig is go.Figure.return_value and fig.add_trace.call_count == 8
    lines = [c.kwargs for c in go.Scatter.call_args_list]
    assert [(d["x"], d["y"]) for d in lines] == [
        ([x0, x1], [y0, y1]) for x0, y0, x1, y1, _ in court.padel_court_segments()]
    assert [d["line"]["dash"] for d in lines].count("dash") == 1  # the net
    layout = fig.update_layout.call_args.kwargs
    assert (layout["width"], layout["height"], layout["showlegend"]) == (300, 600, False)
