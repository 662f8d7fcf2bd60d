"""The window's arithmetic on synthetic timings: a rate over the whole
window, and a tail over every frame (not a median of chunks)."""

import pytest

import tiny  # noqa: F401  (puts the benchmark on the path)
from harness import readers, window


def test_rate_is_the_whole_window_over_its_frames():
    assert window.per_frame_ms(10.0, 400) == pytest.approx(25.0)
    rec = {"window": {"window_s": 10.0, "calls": 100, "frames": 400, "host_s": 0.5,
                      "stamps_ms": []}}
    assert readers.frame_ms(rec) == pytest.approx(25.0)
    assert readers.frame_ms(rec, per_call=True) == pytest.approx(100.0)
    assert readers.host_ms_per_frame(rec) == pytest.approx(1.25)
    with pytest.raises(ValueError):
        window.per_frame_ms(1.0, 0)


def test_p95_is_over_every_frame():
    # 190 frames at 40 ms and 10 stalls of 400 ms: the tail sees the stalls
    # a median of 20 chunks of 10 frames would not
    gaps = [40.0] * 190 + [400.0] * 10
    stamps = [0.0]
    for g in gaps:
        stamps.append(stamps[-1] + g)
    assert window.intervals_ms(stamps) == pytest.approx(gaps)
    assert window.percentile(window.intervals_ms(stamps), 95.0) == 40.0
    assert window.percentile(window.intervals_ms(stamps), 95.5) == 400.0
    rec = {"window": {"stamps_ms": stamps}}
    assert readers.interval_p95_ms(rec) == 40.0
    gaps[180:190] = [400.0] * 10  # 20 stalls of 200: now past the 95th
    stamps = [0.0]
    for g in gaps:
        stamps.append(stamps[-1] + g)
    assert readers.interval_p95_ms({"window": {"stamps_ms": stamps}}) == 400.0


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert window.percentile(xs, 95.0) == 95
    assert window.percentile([3.0], 95.0) == 3.0
    assert window.percentile([5, 1, 4, 2, 3], 50.0) == 3
