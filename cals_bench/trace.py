"""Device time from ``torch.profiler``'s trace of the measured window.

The window runs under a profiler that records the card's activity only
(kernels, copies and sets, CUDA-graph replays included), so the host's
operators add no events. From the trace: the busy time (the union of the
device intervals), each kernel name's total, each kernel family's total
(``kernels/<family>.json`` patterns), and the longest idle gaps, each
named by the host's phase at its start (the harness's spans of the jobs,
mapped onto the trace's clock by a marker copy at the window's start) and
the kernel after it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from dataclasses import dataclass, field


@dataclass
class TraceData:
    busy_s: float
    window_s: float
    kernel_s: dict  # kernel name -> seconds
    family_s: dict  # kernel family -> seconds
    idle_gaps: list = field(default_factory=list)  # [(name, seconds)]


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool = True):
    """A profiler of the card's activity around the block (None when off;
    the host's on a run without a card, whose trace has no device event)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        yield prof


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of every device event in the trace."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            start = e.start_ns() / 1e3
            out.append((e.name(), start, start + e.duration_ns() / 1e3))
    return out


def union(intervals) -> list[tuple[float, float]]:
    """The disjoint, sorted union of (start, end) intervals."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def family_of(name: str, families: dict) -> str | None:
    """The one family whose patterns name the kernel ``name`` (None if no
    family does). A kernel that two families name is an error: its time
    would otherwise go to whichever file sorts first."""
    found = [fam for fam, patterns in families.items() if any(p in name for p in patterns)]
    if len(found) > 1:
        raise ValueError(f"kernel {name!r} is named by the families {found}")
    return found[0] if found else None


def read(events, window_s: float, families: dict, spans=(), marker: str | None = None,
         host_start_us: float = 0.0, n_gaps: int = 10) -> TraceData:
    """Reduce ``events`` (``device_events``) to a ``TraceData``.

    ``spans``: (name, host start us, host end us) of what the host did,
    relative to ``host_start_us``, the host time at which the marker
    (the first event whose name contains ``marker``) was issued."""
    if not events:
        return TraceData(0.0, window_s, {}, {})
    kernel_us: collections.Counter = collections.Counter()
    family_us: collections.Counter = collections.Counter()
    for name, s, e in events:
        kernel_us[name] += e - s
        fam = family_of(name, families)
        if fam is not None:
            family_us[fam] += e - s
    busy = union((s, e) for _, s, e in events)
    offset = 0.0  # trace time of host_start_us
    marked = [s for name, s, _ in events if marker and marker in name]
    if marked:
        offset = min(marked) - host_start_us
    longest = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(busy[:-1], busy[1:])), reverse=True)[:n_gaps]
    starts = sorted((s, name) for name, s, _ in events)
    gaps = []
    for length, e0, s1 in longest:
        nxt = starts[bisect.bisect_left(starts, (s1, ""))][1]
        host = e0 - offset
        phase = next((n for n, a, b in spans if a <= host < b), "between jobs")
        gaps.append((f"{phase} | before {nxt[:80]}", length / 1e6))
    return TraceData(
        busy_s=sum(e - s for s, e in busy) / 1e6,
        window_s=window_s,
        kernel_s={n: us / 1e6 for n, us in kernel_us.items()},
        family_s={f: us / 1e6 for f, us in family_us.items()},
        idle_gaps=gaps,
    )
