"""The kernel wrappers' launch counts, in one place.

Each wrapper that launches a kernel adds one to its own ``launches``
attribute per launch, and nowhere else; the two MTTKRP wrappers count a
launch under a device predicate (``ops/fused_mttkrp.py``) on their
``predicated`` attribute instead. ``ops/mttkrp.py:ROUTES`` counts the
batched MTTKRP results by route (fused, twostep, krp_gemm, dimtree), so a
run shows which route each mode took. ``TALLIES`` holds further counts by
key that observers of the wrappers keep while they watch a run (a dict
each, e.g. launches by shape).

A launch captured into a CUDA graph runs at every replay with no Python
call, so the engine's graph loop (``solvers/graph_loop.Graph``) takes what
a capture added to these counts as what one replay adds (``take_added``)
and adds it again at each replay (``add``).
"""

from __future__ import annotations

COUNTERS = ("launches", "predicated")
TALLIES: list[dict] = []


def counted() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from . import probe_overhead
    from .ops import fused_epilogue, fused_mttkrp, spd_inverse

    return {
        "fused_mttkrp_fp32": fused_mttkrp.fused_mttkrp_fp32,
        "fused_mttkrp_tc": fused_mttkrp.fused_mttkrp_tc,
        "normal_inverse": fused_epilogue.normal_inverse,
        "epilogue_apply": fused_epilogue.epilogue_apply,
        "spd_inverse": spd_inverse.spd_inverse,
        "probe_copy": probe_overhead.probe_copy,
    }


def read() -> dict:
    """``{name: launches}``, and ``{name + ".predicated": n}`` for the
    wrappers that count predicated launches."""
    out = {}
    for name, fn in counted().items():
        out[name] = fn.launches
        if hasattr(fn, "predicated"):
            out[f"{name}.predicated"] = fn.predicated
    return out


def _routes() -> dict:
    from .ops.mttkrp import ROUTES

    return ROUTES


def routes() -> dict:
    """``{route: MTTKRP results}`` (fused, twostep, krp_gemm, dimtree)."""
    return dict(_routes())


def reset() -> None:
    """Every wrapper's counts and the route counts to 0."""
    for fn in counted().values():
        for attr in COUNTERS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)
    routes_ = _routes()
    for key in routes_:
        routes_[key] = 0


def _cells() -> list:
    """(owner, key, count) of every count kept now: the wrappers' counters,
    the route counts and the tallies' keys."""
    cells = [(fn, attr, getattr(fn, attr)) for fn in counted().values() for attr in COUNTERS
             if hasattr(fn, attr)]
    return cells + [(t, key, n) for t in [_routes(), *TALLIES] for key, n in t.items()]


def _set(owner, key, n: int) -> None:
    if isinstance(owner, dict):
        owner[key] = n
    else:
        setattr(owner, key, n)


def snapshot() -> dict:
    """Every count now, for ``take_added``."""
    return {(id(owner), key): n for owner, key, n in _cells()}


def take_added(before: dict) -> list:
    """(owner, key, added) for every count that rose since ``before`` (a
    ``snapshot``), each put back to its value then (a key new to its tally
    is removed)."""
    out = []
    for owner, key, n in _cells():
        was = before.get((id(owner), key))
        if n != (was or 0):
            out.append((owner, key, n - (was or 0)))
            if was is None and isinstance(owner, dict):
                del owner[key]
            else:
                _set(owner, key, was or 0)
    return out


def add(added: list, times: int) -> None:
    """``added`` (from ``take_added``) ``times`` over."""
    for owner, key, d in added:
        n = owner.get(key, 0) if isinstance(owner, dict) else getattr(owner, key)
        _set(owner, key, n + times * d)
