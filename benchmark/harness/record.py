"""What one run records, for the metric readers under benchmark/metrics/.

The harness and the traffic kind fill it; each reader takes one number from
it and returns None where the run has nothing for it to read.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Trace:
    """The device activity that torch.profiler saw over the window."""

    busy_s: float  # union of device activity inside the window
    window_s: float  # the traced window, by the host clock
    n_events: int  # device activities (kernels, copies, fills)
    by_name: dict  # activity name -> [seconds, count]
    idle_gaps: list  # [[what the host was doing, seconds], ...]


@dataclass
class Record:
    kind: str  # the traffic kind, as "matvec"
    setup_s: float | None = None  # process start to the first timed request
    assembly_s: float | None = None  # cluster tree + build, synchronized
    resident_bytes: int | None = None  # device memory held after set-up
    peak_bytes: int | None = None  # device memory peak, set-up and window
    window_s: float | None = None  # first issue to the last completion
    # host clock of each request of the window: issued, call returned, done
    t_issue: list = field(default_factory=list)
    t_return: list = field(default_factory=list)
    t_done: list = field(default_factory=list)
    failed: int = 0
    counters: dict = field(default_factory=dict)  # the kind's own counts
    trace: Trace | None = None

    @property
    def count(self) -> int:
        return len(self.t_done)

    def latencies_s(self) -> list:
        return [d - i for i, d in zip(self.t_issue, self.t_done)]
