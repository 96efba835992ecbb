"""The readers of the engine's stage record (`bench/metrics/_stages.py`):
each returns the mean of its key over the window's batches, in its unit,
and nothing without the key, without the card's trace, or where the
window's total is 0."""
import pytest

from bench import harness

READERS = {"host_sample_ms": ("sample_s", 1e3),
           "host_gather_ms": ("gather_s", 1e3),
           "host_factors_ms": ("factors_s", 1e3),
           "host_pack_ms": ("pack_s", 1e3),
           "dispatch_ms": ("dispatch_s", 1e3)}


class _Ctx:
    def __init__(self, timings, trace=object()):
        self.batch_timings = timings
        self.trace = trace
        self.n_batches = len(timings)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_takes_the_mean_of_its_key(metric):
    key, scale = READERS[metric]
    read = harness.load_reader(metric).read
    vals = [0.125, 0.5, 0.25]
    timings = [{"host_s": 1.0, "n": 500, key: v} for v in vals]
    assert read(_Ctx(timings)) == pytest.approx(scale * sum(vals) / 3)
    assert isinstance(read(_Ctx(timings)), float)
    assert read(_Ctx(timings, trace=None)) is None
    assert read(_Ctx([{"host_s": 1.0, "n": 500}] + timings)) is None
    assert read(_Ctx([{key: 0 * v} for v in vals])) is None
    assert read(_Ctx([])) is None
