"""The program's own spans and counters in a traced run, and the device's
idle gaps named by them.

The program (``cp_cals_tpu_torch/utils/timers.py``) records its spans and
counters while a ``torch.profiler`` session runs, so a ``--trace 1``
window carries them, and a ``--trace 0`` run none. Its spans are stamped
on the profiler's clock: a span and a device event of the same trace
compare with no marker. ``recorded()`` reads them after the window (None
where the program has no recorder or recorded nothing); the per-layer
readers sum them (``seconds``).

``name_gaps`` reduces the trace as ``trace.read`` does and names each of
the longest idle gaps by the program span that holds most of it (the
innermost span open at each instant), as ``<job-level span> > <program
span> | before <kernel>``, with today's name where no program span covers
the gap; and it sums the whole window's idle seconds under each innermost
program span.
"""

from __future__ import annotations

import bisect
import collections

from . import trace as tracing


def recorded():
    """(spans, counters) of the program's last recording, or None."""
    try:
        from cp_cals_tpu_torch.utils import timers
    except ImportError:
        return None
    if not hasattr(timers, "spans"):
        return None
    spans = timers.spans()
    if not spans:
        return None
    return spans, timers.counters()


def seconds(spans, name: str) -> float:
    """The summed seconds of the spans called ``name``."""
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e9


def label(span) -> str:
    return span.name if span.tag is None else f"{span.name}[{span.tag}]"


def innermost(spans) -> list[tuple[float, float, str]]:
    """(start us, end us, label) of disjoint pieces of time, each under the
    innermost span open then (spans nest within a thread; the engine's
    cells run one bucket thread)."""
    out = []
    stack: list = []
    t = None
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        a, b = s.start_ns / 1e3, s.end_ns / 1e3
        while stack and stack[-1][1] <= a:
            top = stack.pop()
            if top[1] > t:
                out.append((t, top[1], top[2]))
            t = max(t, top[1])
        if stack and a > t:
            out.append((t, a, stack[-1][2]))
        stack.append((a, b, label(s)))
        t = a
    while stack:
        top = stack.pop()
        if top[1] > t:
            out.append((t, top[1], top[2]))
        t = max(t, top[1])
    return out


def _overlaps(pieces, starts, a: float, b: float):
    """(label, overlap us) of the pieces that overlap [a, b)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(pieces) and pieces[i][0] < b:
        s, e, name = pieces[i]
        ov = min(e, b) - max(s, a)
        if ov > 0:
            yield name, ov
        i += 1


def name_gaps(events, window_s: float, families: dict, spans=(), marker: str | None = None,
              host_start_us: float = 0.0, program=(), n_gaps: int = 10):
    """``trace.read`` of the same arguments, its ``idle_gaps`` named by the
    program's spans (``program``: ``timers.Span``s on the profiler's
    clock), and the idle seconds under each innermost program span
    (``"none"``: under none) over the whole trace."""
    data = tracing.read(events, window_s, families, spans, marker, host_start_us, n_gaps)
    if not events or not program:
        return data, {}
    busy = tracing.union((s, e) for _, s, e in events)
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy[:-1], busy[1:])]
    pieces = innermost(program)
    starts = [p[0] for p in pieces]
    idle: collections.Counter = collections.Counter()
    for a, b in gaps:
        covered = 0.0
        for name, ov in _overlaps(pieces, starts, a, b):
            idle[name] += ov / 1e6
            covered += ov
        idle["none"] += (b - a - covered) / 1e6
    longest = sorted(((b - a, a, b) for a, b in gaps), reverse=True)[:n_gaps]  # trace.read's order
    named = []
    for (_, a, b), (old, length) in zip(longest, data.idle_gaps):
        held = collections.Counter()
        for name, ov in _overlaps(pieces, starts, a, b):
            held[name] += ov
        if held:
            phase, kernel = old.split(" | before ", 1)
            old = f"{phase} > {held.most_common(1)[0][0]} | before {kernel}"
        named.append((old, length))
    data.idle_gaps = named
    return data, dict(idle)
