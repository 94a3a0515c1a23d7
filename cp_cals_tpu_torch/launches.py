"""The kernel wrappers' launch counts, in one place.

Each wrapper that launches a kernel is a ``Wrapper`` and adds one to its
``launches`` per launch (``count``), and nowhere else; the two MTTKRP
wrappers count a launch under a device predicate
(``ops/fused_mttkrp.py``) on their ``predicated`` count instead.
``ops/mttkrp.py:ROUTES`` counts the batched MTTKRP results by route (fused,
twostep, krp_gemm, dimtree), so a run shows which route each mode took,
``ops/mttkrp.py:LAYOUTS`` the layouts derived inside the iteration, and
``ops/fused_mttkrp.py:BALANCED`` the tensor-core launches whose j splits
fill more than one wave.
``TALLIES`` holds further counts by key that observers of the wrappers keep
while they watch a run (a ``Tally`` each, e.g. launches by shape).

Every count is a ``Tally``: each thread adds to a part of its own, and a
read sums the parts, so the engine's bucket threads count exactly without
a lock on the launch path; a bucket thread's part joins a common one when
its bucket ends (``retire_thread``), so parts do not pile up over calls. A launch captured into a CUDA graph runs at
every replay with no Python call, so the engine's graph loop
(``solvers/graph_loop.Graph``) takes what a capture added to the capturing
thread's parts as what one replay adds (``snapshot``, ``take_added``),
and adds it again at each replay (``add``), in the replaying thread.
Another thread's launches during a capture stay that thread's.
"""

from __future__ import annotations

import functools
import threading
from collections.abc import MutableMapping


class Tally(MutableMapping):
    """Counts by key, kept in one part per thread (by thread ident) and a
    common part that ``retire`` folds a thread's part into. A read sums the
    parts; ``fixed`` keys read 0 when no part holds them. Adding (``add``)
    is exact under threads; setting a count adds its difference to the
    calling thread's part; ``clear`` and ``del`` are for moments when no
    other thread counts."""

    def __init__(self, initial=None, fixed=()):
        self._fixed = tuple(fixed)
        self._parts: dict[int, dict] = {}
        self._common: dict = {}
        self._lock = threading.Lock()
        if initial:
            self.update(initial)

    def _own(self) -> dict:
        ident = threading.get_ident()
        part = self._parts.get(ident)
        if part is None:
            with self._lock:
                part = self._parts.setdefault(ident, {})
        return part

    def add(self, key, n: int = 1) -> None:
        part = self._own()
        part[key] = part.get(key, 0) + n

    def mine(self) -> dict:
        """A copy of the calling thread's part."""
        return dict(self._own())

    def put_back(self, key, n: int | None) -> None:
        """The calling thread's part of ``key`` to ``n`` (None: removed)."""
        part = self._own()
        if n is None:
            part.pop(key, None)
        else:
            part[key] = n

    def retire(self) -> None:
        """The calling thread's part, folded into the common part."""
        with self._lock:
            part = self._parts.pop(threading.get_ident(), None)
            for key, n in (part or {}).items():
                self._common[key] = self._common.get(key, 0) + n

    def _sum(self) -> dict:
        with self._lock:
            parts = [dict(self._common), *self._parts.values()]
        out = dict.fromkeys(self._fixed, 0)
        for part in parts:
            for key, n in dict(part).items():  # one copy under the GIL: its owner may be adding
                out[key] = out.get(key, 0) + n
        return out

    def __getitem__(self, key):
        return self._sum()[key]

    def __setitem__(self, key, n: int) -> None:
        self.add(key, n - self.get(key, 0))

    def __delitem__(self, key) -> None:
        if key not in self._sum():
            raise KeyError(key)
        with self._lock:
            for part in (self._common, *self._parts.values()):
                part.pop(key, None)

    def __iter__(self):
        return iter(self._sum())

    def __len__(self) -> int:
        return len(self._sum())

    def clear(self) -> None:
        with self._lock:
            self._parts.clear()
            self._common.clear()

    def __repr__(self) -> str:
        return repr(self._sum())


KERNELS = Tally()  # "<name>" and "<name>.predicated" -> launches
TALLIES: list[Tally] = []


class Wrapper:
    """A kernel wrapper (the function it wraps, by its name) with its
    launch counts: ``launches``, and with ``predicated`` the launches under
    a device predicate, both read from ``KERNELS``."""

    def __init__(self, fn, predicated: bool = False):
        functools.update_wrapper(self, fn)
        self._fn, self._predicated = fn, predicated

    def __call__(self, *args, **kw):
        return self._fn(*args, **kw)

    def count(self, predicated: bool = False) -> None:
        """One launch, by the calling thread."""
        KERNELS.add(f"{self.__name__}.predicated" if predicated else self.__name__)

    @property
    def launches(self) -> int:
        return KERNELS.get(self.__name__, 0)

    @launches.setter
    def launches(self, n: int) -> None:
        KERNELS[self.__name__] = n

    @property
    def predicated(self) -> int:
        if not self._predicated:
            raise AttributeError(f"{self.__name__} counts no predicated launches")
        return KERNELS.get(f"{self.__name__}.predicated", 0)

    @predicated.setter
    def predicated(self, n: int) -> None:
        KERNELS[f"{self.__name__}.predicated"] = n


def wrapper(predicated: bool = False):
    """Decorator: the function as a counted kernel ``Wrapper``."""
    return lambda fn: Wrapper(fn, predicated)


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


def _routes() -> Tally:
    from .ops.mttkrp import ROUTES

    return ROUTES


def _layouts() -> Tally:
    from .ops.mttkrp import LAYOUTS

    return LAYOUTS


def _balanced() -> Tally:
    from .ops.fused_mttkrp import BALANCED

    return BALANCED


def routes() -> dict:
    """``{route: MTTKRP results}`` (fused, twostep, krp_gemm, dimtree)."""
    return dict(_routes())


def reset() -> None:
    """Every wrapper's counts, the route counts, the derived layouts' and
    the balanced tensor-core launches' to 0 (while no thread counts)."""
    KERNELS.clear()
    _routes().clear()
    _layouts().clear()
    _balanced().clear()


def _tallies() -> list:
    return [KERNELS, _routes(), _layouts(), _balanced(), *TALLIES]


def retire_thread() -> None:
    """The calling thread's part of every count, folded into the common
    part (``Tally.retire``): for a thread whose counting is over, with no
    capture window of its own open."""
    for t in _tallies():
        t.retire()


def snapshot() -> dict:
    """The calling thread's part of every count now, for ``take_added``."""
    return {(id(t), key): n for t in _tallies() for key, n in t.mine().items()}


def take_added(before: dict) -> list:
    """(tally, key, added) for every count the calling thread raised since
    ``before`` (a ``snapshot``), each put back to its value then (a key new
    to the thread's part is removed)."""
    out = []
    for t in _tallies():
        for key, n in t.mine().items():
            was = before.get((id(t), key))
            if n != (was or 0):
                out.append((t, key, n - (was or 0)))
                t.put_back(key, was)
    return out


def add(added: list, times: int) -> None:
    """``added`` (from ``take_added``) ``times`` over, by the calling
    thread."""
    for t, key, d in added:
        t.add(key, times * d)
