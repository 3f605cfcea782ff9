"""Shared fixtures.  NOTE: device count must stay 1 here (smoke tests and
benches see a single CPU device); multi-device tests spawn subprocesses
with their own XLA_FLAGS (see tests/test_multidevice.py)."""
import jax
import pytest

# Process-wide XLA compile counter.  jax.monitoring emits a duration event
# whose key contains "backend_compile" for every XLA compilation (a single
# jit may emit several); registered once at import so counts are monotone
# across the whole test session and fixtures can snapshot deltas.
_XLA_COMPILES = [0]


def _count_compiles(event: str, duration: float, **kwargs) -> None:
    if "backend_compile" in event:
        _XLA_COMPILES[0] += 1


jax.monitoring.register_event_duration_secs_listener(_count_compiles)

# Runtime sanitizer mode: `RPCA_SANITIZE=1 pytest ...` flips on
# jax_debug_nans + tracer-leak checking + the transfer guard for the whole
# session (see src/repro/debug.py; CI's static-analysis job runs a tier-1
# subset this way).  Enabled at import so it precedes any tracing.
from repro import debug as _rpca_debug  # noqa: E402

_rpca_debug.enable_from_env()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "sanitizer_incompatible(reason): test intentionally produces "
        "NaN/divergence or asserts compile counts that jax_debug_nans "
        "perturbs; skipped when RPCA_SANITIZE is active",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's kernels); skipped without one",
    )


def pytest_collection_modifyitems(config, items):
    if not _rpca_debug.active():
        return
    for item in items:
        mark = item.get_closest_marker("sanitizer_incompatible")
        if mark is not None:
            reason = mark.args[0] if mark.args else "sanitizer-incompatible"
            item.add_marker(pytest.mark.skip(
                reason=f"RPCA_SANITIZE active: {reason}"))


@pytest.fixture
def sanitizer():
    """Force-enable the sanitizer for one test (restored afterwards).
    Tests that need NaN-raising / transfer-guard semantics regardless of
    the session env use this."""
    was_active = _rpca_debug.active()
    _rpca_debug.enable("log")
    yield _rpca_debug
    if not was_active:
        _rpca_debug.disable()


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture
def xla_compiles():
    """Callable returning the cumulative XLA compile-event count.  Tests
    assert ``counter() - before == 0`` to prove a dispatch was retrace-
    and recompile-free."""
    return lambda: _XLA_COMPILES[0]


@pytest.fixture
def fresh_cache(monkeypatch):
    """A fresh process-default compile cache for the duration of one test
    (counters and entries start empty; the real default is untouched)."""
    from repro.core import compile_cache as cc

    cache = cc.CompileCache()
    monkeypatch.setattr(cc, "_DEFAULT_CACHE", cache)
    return cache
