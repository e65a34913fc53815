"""Reading the program's own span recorder (pathtracer_tpu_torch/utils/
spans.py) at the end of a run on the card: the median of each list's
untraced samples, so that a traced run reads its untraced frames.

Every reading is None where the run was not on a CUDA device, where the
program has no recorder (a program older than it), or where it recorded
nothing of the kind (the eager frame, the recorder off).
"""
from __future__ import annotations

import statistics


def snapshot(out) -> dict | None:
    """The recorder's snapshot after a run on the card, else None."""
    if out.kind == "cpu":
        return None
    try:
        from pathtracer_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.snapshot()


def untraced_median(samples) -> float | None:
    """The median of the values of [[value, traced]] samples that ran
    without the profiler, or None where there are none."""
    vals = [v for v, traced in samples or () if not traced]
    return statistics.median(vals) if vals else None


def device_ms(out, stage: str) -> float | None:
    """Median device ms an iteration of a stage of the compiled frame."""
    snap = snapshot(out)
    return snap and untraced_median(snap["device_ms"].get(stage))


def host_s(out, name: str) -> float | None:
    """Median host seconds of the span `name`."""
    snap = snapshot(out)
    return snap and untraced_median(snap["host_s"].get(name))


def counter(out, name: str):
    """The recorder's counter `name`, or None where it has none."""
    snap = snapshot(out)
    return snap and snap["counters"].get(name)


def frame_host_s(out) -> float | None:
    """Median host seconds of the compiled frame's calls (pt_frame) that
    captured nothing."""
    snap = snapshot(out)
    if not snap:
        return None
    captured = {r[5] for r in snap["spans"] if r[1] == "pt_frame.capture"}
    return untraced_median([[r[3] - r[2], r[6]] for r in snap["spans"]
                            if r[1] == "pt_frame" and r[5] not in captured])
