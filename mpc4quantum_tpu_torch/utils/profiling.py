"""The port's tracing: the span recorder `spans`, the operator's trace
exporter `profile_trace`, and the count of the host's reads of device
flags that a data-dependent exit makes (`host_flag`).

Where a step runs as CUDA-graph replays (mpc/step_graphs.py), the spans
inside it are opened between the replays, in the order the capture met
them, so the events of a timed span enclose the replays of its phase.

The recorder is on only while torch.profiler records: `FleetRunner.run`
reads that once as it is entered (`spans.run`) and holds it for the run.
Off, a span site (`with spans.span(name):`) costs one flag test and enters
a shared no-op context. On, a span opens a
`torch.profiler.record_function` range, so the Chrome trace holds it as a
"user_annotation" on the clock of the device's kernels, and appends a
`Span` record to memory: its name, host start and end
(time.perf_counter_ns), its parent span and the id of its run. A span
opened with events=True in a run on a CUDA device also records a CUDA
event on the current stream at each end; nothing synchronizes or reads
them while the run goes on. The records of the newest KEEP_RUNS runs are
kept (`spans.runs`).

The spans and their sites:
  fleet.run      FleetRunner.run (the root; its records share its run id)
  fleet.step     FleetRunner.step and mpc/step_graphs.StepGraphs.step, attrs
                 {"phase": "warm" | "steady", "graph": "replay" | "capture" | "eager"}
  sqp.iter       FleetRunner._sqp_iter
  sqp.linearize  the SQP iteration's linearization (events)
  qp.condense    solvers/condense.qp_data inside quad_program (events)
  qp.kinv        each round's K^-1 build of solvers/boxqp.solve_boxqp_fixed (events)
  plant.step     the plant step that FleetRunner.step hands to driver.advance (events)
  host.flag      the host's read in `host_flag`
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

import torch

# the runs whose span records the recorder keeps
KEEP_RUNS = 64

_NOOP = contextlib.nullcontext()


class Span:
    """One span's record, and the context that opens and closes it.

    name; start_ns, end_ns: the host's perf_counter_ns at its two ends;
    parent: the enclosing Span (None for fleet.run); run: the run id;
    attrs: a dict or None; events: the (start, end) CUDA events, or None."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "run", "attrs", "events",
                 "_recorder", "_range", "_timed")

    def __init__(self, recorder: "SpanRecorder", name: str, timed: bool, attrs):
        self.name, self.attrs, self._recorder, self._timed = name, attrs, recorder, timed
        self.start_ns = self.end_ns = 0
        self.parent = self.events = None

    def __enter__(self):
        rec = self._recorder
        self.parent = rec.open[-1] if rec.open else None
        self.run = rec.run_id
        rec.runs[-1].append(self)
        rec.open.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self._timed:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._timed:
            self.events[1].record()
        self._range.__exit__(*exc)
        self._recorder.open.pop()
        self._range = self._recorder = None
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def stream_ms(self) -> Optional[float]:
        """Milliseconds on the stream between the span's two events, None
        without them; read once the stream has passed the second."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])


class SpanRecorder:
    """The spans of the newest KEEP_RUNS runs (`runs`: a list of Spans a
    run, its fleet.run first); on (`on`) only inside a run that began while
    torch.profiler recorded."""

    def __init__(self):
        self.on = False
        self.cuda = False
        self.run_id = 0
        self.runs: collections.deque = collections.deque(maxlen=KEEP_RUNS)
        self.open: list = []
        # while mpc/step_graphs captures a piece of a step: the capture,
        # which takes each span site as a mark in its script
        self.capture = None

    def span(self, name: str, events: bool = False, **attrs):
        """A span named `name` (a context); events=True also times it on
        the stream of a CUDA run. Off: the shared no-op context. During a
        step capture: the capture's mark (mpc/step_graphs)."""
        if self.capture is not None:
            return self.capture.span(name, events, attrs or None)
        if not self.on:
            return _NOOP
        return Span(self, name, events and self.cuda, attrs or None)

    @contextlib.contextmanager
    def run(self, device):
        """The fleet.run span of one run on `device`: the recorder is on for
        the run if torch.profiler records as it begins."""
        if not torch.autograd.profiler._is_profiler_enabled:
            yield
            return
        self.on, self.cuda = True, torch.device(device).type == "cuda"
        self.run_id += 1
        self.runs.append([])
        try:
            with self.span("fleet.run"):
                yield
        finally:
            self.on = False
            self.open.clear()


spans = SpanRecorder()


def _wait() -> None:
    """Wait for the card's queued work, where the process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """torch.profiler over the block (CPU, and CUDA where there is a card),
    its Chrome trace, which holds the program's spans, written to
    logdir/trace.json; no-op when logdir is None. Yields the profiler (None
    when off) for key_averages()."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _wait()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def host_flag(flag: torch.Tensor) -> bool:
    """bool(flag) of a one-element flag: on the card the host waits for the
    queued work and copies the flag back (the span host.flag). Each call
    adds one to host_flag.reads, the count of such reads."""
    host_flag.reads += 1
    with spans.span("host.flag"):
        return bool(flag)


host_flag.reads = 0
