"""A scripted stand-in for streamlit, for the dashboard tests of the port
(tests/test_torch_streamlit_app.py): a copy of the JAX suite's stub in
tests/test_streamlit_app.py. Widgets return script[label] or a default;
render calls are recorded for assertions."""

import collections
import types


class _Ctx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FakeStreamlit(types.ModuleType):
    """Scripted streamlit: widgets return script[label] or a sane default;
    render calls are recorded for assertions."""

    def __init__(self, script):
        super().__init__("streamlit")
        self.session_state = {}
        self._script = dict(script)
        self.calls = collections.defaultdict(list)

    # -- widgets ---------------------------------------------------------
    def _value(self, label, default):
        return self._script.get(label, default)

    def fragment(self, fn):
        return fn

    def text_input(self, label, value=""):
        return self._value(label, value)

    def form_submit_button(self, label="Submit"):
        return self._value(label, True)

    def slider(self, label, *args, **kwargs):
        default = args[2] if len(args) >= 3 else (args[0] if args else 0)
        return self._value(label, kwargs.get("value", default))

    def number_input(self, label, min_value=0, max_value=None, **kwargs):
        return self._value(label, min_value)

    def radio(self, label, options=None, **kwargs):
        return self._value(label, options[0])

    def checkbox(self, label, value=False):
        return self._value(label, True)

    def columns(self, spec):
        return tuple(_Ctx() for _ in spec)

    def form(self, name):
        return _Ctx()

    def spinner(self, msg):
        return _Ctx()

    # -- render sinks ------------------------------------------------------
    def _sink(self, name, *args, **kwargs):
        self.calls[name].append(args)

    def __getattr__(self, name):
        if name in (
            "title", "image", "write", "plotly_chart", "subheader",
            "video", "header", "dataframe", "markdown", "success",
        ):
            return lambda *a, **k: self._sink(name, *a, **k)
        raise AttributeError(name)
