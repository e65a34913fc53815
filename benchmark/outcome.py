"""What the harness hands a traffic mode, and what the mode hands back."""
from __future__ import annotations

import dataclasses

from .spec import Cell


@dataclasses.dataclass
class Run:
    """What a traffic mode is given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str          # "cuda", or "cpu" in the tests
    t0: float            # perf_counter at process start


@dataclasses.dataclass
class Outcome:
    """What a traffic mode hands back."""

    end_to_end: dict                 # metric name -> value
    attempted: int
    failed: int
    memory_peak_bytes: int
    kind: str                        # the device's name
    answers: dict                    # what the check compares
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None        # trace.summarize of the traced rank
    busy_s: float | None = None      # averaged over the chips
    window_s: float | None = None
