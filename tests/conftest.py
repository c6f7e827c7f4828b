"""Shared test config.

Installs a minimal deterministic stand-in for ``hypothesis`` when the real
package is absent (this container ships without it): ``@given`` draws a fixed
number of pseudo-random examples from a seed derived from the test name, so
runs are reproducible and the property tests keep their coverage shape.
"""
import sys
import types
import zlib

try:  # pragma: no cover - exercised only when hypothesis is installed
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import numpy as np

    _MAX_EXAMPLES_CAP = 50

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def example(self, rng):
            return self._draw(rng)

        def flatmap(self, fn):
            return _Strategy(lambda rng: fn(self._draw(rng))._draw(rng))

        def map(self, fn):
            return _Strategy(lambda rng: fn(self._draw(rng)))

    def _integers(min_value, max_value):
        return _Strategy(lambda rng: int(rng.integers(min_value, max_value + 1)))

    def _floats(min_value, max_value):
        return _Strategy(lambda rng: float(rng.uniform(min_value, max_value)))

    def _booleans():
        return _Strategy(lambda rng: bool(rng.integers(0, 2)))

    def _sampled_from(seq):
        seq = list(seq)
        return _Strategy(lambda rng: seq[int(rng.integers(0, len(seq)))])

    def _builds(fn, *strategies):
        return _Strategy(lambda rng: fn(*[s._draw(rng) for s in strategies]))

    def _lists(elements, min_size=0, max_size=10):
        def draw(rng):
            n = int(rng.integers(min_size, max_size + 1))
            return [elements._draw(rng) for _ in range(n)]
        return _Strategy(draw)

    def _settings(max_examples=20, deadline=None, **_kw):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn
        return deco

    def _given(*strategies):
        def deco(fn):
            def wrapper():
                n = min(getattr(wrapper, "_stub_max_examples", 20),
                        _MAX_EXAMPLES_CAP)
                seed = zlib.crc32(fn.__qualname__.encode())
                rng = np.random.default_rng(seed)
                for _ in range(n):
                    fn(*[s.example(rng) for s in strategies])
            # copy identity without __wrapped__: pytest must see a
            # zero-argument signature, not the strategy parameters
            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            wrapper._stub_max_examples = getattr(fn, "_stub_max_examples", 20)
            return wrapper
        return deco

    _hyp = types.ModuleType("hypothesis")
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.booleans = _booleans
    _st.sampled_from = _sampled_from
    _st.builds = _builds
    _st.lists = _lists
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.HealthCheck = types.SimpleNamespace(all=staticmethod(lambda: []))
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips without one")
