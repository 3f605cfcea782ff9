"""The port's serving host parts against the JAX reference's, on the CPU:
the paged column-plane pool (``repro_torch.serving.pages`` against
``repro.serving.pages``) and the observability collectors
(``repro_torch.serving.metrics`` against ``repro.serving.metrics``).

Both are numpy on the host, so the bar is equality: the same planes back
from ``get``, the same page tables, ``stats()`` and free lists over the
same put/free sequences (ragged and interleaved ones included), the same
error types and text, and the same summaries under one injected clock.
"""
import numpy as np
import pytest

from repro.core import validate as jvalidate
from repro.serving import metrics as jmetrics
from repro.serving import pages as jpages
from repro_torch.core import validate
from repro_torch.serving import metrics, pages


def _plane(n_cols, seed=0, m=12, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n_cols)).astype(dtype)


def _same_table(a, b):
    assert a.handles == b.handles
    for name in ("page_indptr", "page_indices", "last_page_cols"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def _same_pools(port, ref):
    assert port.free_pages == ref.free_pages
    assert port.used_pages == ref.used_pages
    assert port._free == ref._free
    assert port.stats() == ref.stats()
    assert len(port) == len(ref)
    assert port.live_bytes == ref.live_bytes
    assert port.allocated_bytes == ref.allocated_bytes
    assert port.capacity_bytes == ref.capacity_bytes
    _same_table(port.table(), ref.table())
    for e, f in zip(port, ref, strict=True):
        assert (e.handle, e.n_cols, e.page_ids, e.dtype) == \
            (f.handle, f.n_cols, f.page_ids, f.dtype)
        assert np.array_equal(port.get(e.handle), ref.get(f.handle))


def _raises_alike(call_port, call_ref, port_type, ref_type):
    with pytest.raises(port_type) as got:
        call_port()
    with pytest.raises(ref_type) as want:
        call_ref()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# PagePool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_cols", [1, 7, 8, 9, 16, 31, 40])
def test_pool_roundtrip_ragged_is_the_references(n_cols):
    """tests/test_gateway.py:58-71 on both pools: bit-exact planes, the
    same page spans, tables and stats at every width."""
    port = pages.PagePool(m=12, page_cols=8, num_pages=8)
    ref = jpages.PagePool(m=12, page_cols=8, num_pages=8)
    plane = _plane(n_cols, seed=n_cols)
    hp, hr = port.put(plane), ref.put(plane)
    assert hp == hr and port.pages_for(n_cols) == ref.pages_for(n_cols)
    out = port.get(hp)
    assert out.dtype == plane.dtype and np.array_equal(out, plane)
    _same_pools(port, ref)
    port.free(hp)
    ref.free(hr)
    _same_pools(port, ref)
    assert port.used_pages == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_random_put_free_sequences_are_the_references(seed):
    """Random interleavings of ragged puts and frees (some at capacity):
    the same handles, free lists, tables, stats and typed refusals."""
    rng = np.random.default_rng(seed)
    port = pages.PagePool(m=6, page_cols=4, num_pages=10)
    ref = jpages.PagePool(m=6, page_cols=4, num_pages=10)
    live = []
    for step in range(40):
        if live and rng.random() < 0.4:
            h = live.pop(int(rng.integers(len(live))))
            port.free(h)
            ref.free(h)
        else:
            plane = _plane(int(rng.integers(1, 17)), seed=step, m=6)
            fits = port.fits(plane.shape[1])
            assert fits == ref.fits(plane.shape[1])
            if fits:
                h = port.put(plane)
                assert ref.put(plane) == h
                live.append(h)
            else:
                _raises_alike(lambda: port.put(plane),
                              lambda: ref.put(plane),
                              validate.CapacityError,
                              jvalidate.CapacityError)
        _same_pools(port, ref)


def test_pool_interleaved_lifecycle():
    """tests/test_gateway.py:74-90: freed pages are reused, surviving
    entries stay intact, a dead handle is refused alike."""
    port = pages.PagePool(m=6, page_cols=4, num_pages=6)
    ref = jpages.PagePool(m=6, page_cols=4, num_pages=6)
    a, b, c = (_plane(k, seed=s, m=6) for k, s in ((10, 1), (9, 2), (11, 3)))
    ha, hb = port.put(a), port.put(b)
    ref.put(a), ref.put(b)
    assert port.free_pages == 0
    port.free(ha)
    ref.free(ha)
    hc = port.put(c)
    assert ref.put(c) == hc
    np.testing.assert_array_equal(port.get(hb), b)
    np.testing.assert_array_equal(port.get(hc), c)
    _same_pools(port, ref)
    _raises_alike(lambda: port.get(ha), lambda: ref.get(ha), ValueError,
                  ValueError)


def test_pool_capacity_typed():
    port = pages.PagePool(m=4, page_cols=4, num_pages=2)
    ref = jpages.PagePool(m=4, page_cols=4, num_pages=2)
    port.put(_plane(8, m=4))
    ref.put(_plane(8, m=4))
    assert not port.fits(1) and not ref.fits(1)
    _raises_alike(lambda: port.put(_plane(1, m=4)),
                  lambda: ref.put(_plane(1, m=4)),
                  validate.QueueFull, jvalidate.QueueFull)
    assert issubclass(validate.QueueFull, validate.CapacityError)


@pytest.mark.parametrize("shape,dtype", [((5, 4), np.float32),
                                         ((4, 0), np.float32),
                                         ((4, 9), np.float32),
                                         ((4, 4), np.float64),
                                         ((4,), np.float32)])
def test_pool_never_valid_reads_as_the_reference(shape, dtype):
    """Wrong rows, no or too many columns, a lossy dtype, a 1-D plane:
    ValueError with the reference's words."""
    port = pages.PagePool(m=4, page_cols=4, num_pages=2)
    ref = jpages.PagePool(m=4, page_cols=4, num_pages=2)
    x = np.zeros(shape, dtype)
    _raises_alike(lambda: port.put(x), lambda: ref.put(x), ValueError,
                  ValueError)


@pytest.mark.parametrize("kw", [dict(m=0, page_cols=4, num_pages=2),
                                dict(m=4, page_cols=0, num_pages=2),
                                dict(m=4, page_cols=4, num_pages=0)])
def test_pool_geometry_checks_read_as_the_reference(kw):
    _raises_alike(lambda: pages.PagePool(**kw),
                  lambda: jpages.PagePool(**kw), ValueError, ValueError)


def test_pool_exact_upcast_and_table_and_waste():
    """tests/test_gateway.py:111-137, plus a float16 plane stored by its
    exact upcast: the same table (hyadmin's layout), gather and waste."""
    port = pages.PagePool(m=10, page_cols=8, num_pages=8)
    ref = jpages.PagePool(m=10, page_cols=8, num_pages=8)
    for plane in (_plane(13, seed=4, m=10), _plane(8, seed=5, m=10),
                  _plane(3, seed=6, m=10, dtype=np.float16)):
        assert port.put(plane) == ref.put(plane)
    _same_pools(port, ref)
    t = port.table()
    np.testing.assert_array_equal(t.page_indptr, [0, 2, 3, 4])
    np.testing.assert_array_equal(t.last_page_cols, [5, 8, 3])
    rebuilt = np.concatenate([port._pages[p] for p in t.page_indices[0:2]],
                             axis=1)[:, :13]
    np.testing.assert_array_equal(rebuilt, port.get(0))
    assert port.stats()["waste_ratio"] == pytest.approx(32 / 24)
    for h in (0, 1, 2):
        port.free(h)
        ref.free(h)
    _same_pools(port, ref)
    assert port.stats()["waste_ratio"] == 1.0


# ---------------------------------------------------------------------------
# Observability collectors
# ---------------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_latency_window_is_the_references():
    port, ref = metrics.LatencyWindow(4), jmetrics.LatencyWindow(4)
    assert port.summary() == ref.summary()
    rng = np.random.default_rng(3)
    for x in rng.random(11):
        port.record(x)
        ref.record(x)
        assert port.summary() == ref.summary()
    _raises_alike(lambda: metrics.LatencyWindow(0),
                  lambda: jmetrics.LatencyWindow(0), ValueError, ValueError)


def test_rate_meter_under_an_injected_clock_is_the_references():
    clock = _Clock()
    port = metrics.RateMeter(5.0, clock=clock)
    ref = jmetrics.RateMeter(5.0, clock=clock)
    assert port.rate() == ref.rate() == 0.0
    for step, count in enumerate((3, 0, 7, 2, 9, 1, 4)):
        clock.now += 1.5 if step % 3 else 4.0
        port.add(count)
        ref.add(count)
        assert port.rate() == ref.rate()
        assert port.total == ref.total
    clock.now += 60.0  # idle gap: the window decays to nothing
    assert port.rate() == ref.rate() == 0.0
    _raises_alike(lambda: metrics.RateMeter(0.0),
                  lambda: jmetrics.RateMeter(0.0), ValueError, ValueError)


def test_outcome_counter_vocabulary_is_the_references():
    """tests/test_gateway.py:401-421 on both counters."""
    port, ref = metrics.OutcomeCounter(), jmetrics.OutcomeCounter()
    assert port.KINDS == ref.KINDS
    for kind in ("ok", "ok", "diverged", "shed"):
        port.add(kind)
        ref.add(kind)
        assert port.summary() == ref.summary()
        assert port.completed == ref.completed
    assert port["ok"] == 2 and port.summary() == {
        "completed": 3, "diverged": 1, "shed": 1}
    _raises_alike(lambda: port.add("exploded"), lambda: ref.add("exploded"),
                  ValueError, ValueError)
