"""The program's span records of the last traced window, for the readers
of the spans (mpc4quantum_tpu_torch.utils.profiling.spans, on only while
torch.profiler records).

The recorder keeps the spans of its newest runs, and a traced window may
be one of several that devtrace.profile made. The window's runs are those
whose fleet.run span began no earlier than the newest span's end less the
window's length (devtrace times it on the same perf_counter clock). None
where the imported program has no recorder, or the window holds no run.
"""


def records(s):
    """[Span] of the window `s` (a devtrace.Summary) of its runs, or None."""
    try:
        from mpc4quantum_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    runs = [run for run in spans.runs if run]
    if not runs:
        return None
    since = max(sp.end_ns for run in runs for sp in run) - s.window_s * 1e9
    out = [sp for run in runs if run[0].start_ns >= since for sp in run]
    return out or None


def named(s, *names):
    """The window's spans named one of `names`, or None (see records)."""
    recs = records(s)
    return None if recs is None else [sp for sp in recs if sp.name in names]


def stream_ms_per_step(s, *names):
    """Milliseconds on the stream of the spans named `names`, per fleet.step
    of the window (a rescue pass's steps included); None off a fleet cell,
    where the window holds none of them, or where they carry no events (a
    run off the card)."""
    if s.entry != "fleet":
        return None
    recs = records(s)
    if recs is None:
        return None
    timed = [sp.stream_ms() for sp in recs if sp.name in names]
    steps = sum(1 for sp in recs if sp.name == "fleet.step")
    if not timed or not steps or None in timed:
        return None
    return sum(timed) / steps
