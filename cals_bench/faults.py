"""Faults planted in the program's timed path. The check's own test plants
each at a size the CPU holds, and ``control.py --faults`` at a cell's own
size on the card; each must read not correct.

A fault is ``fault(patch)``, which breaks the path through
``patch(owner, name, value)`` (pytest's ``monkeypatch.setattr``, or the
one ``planted`` gives). The exchange between chips has no fault here:
every cell runs on one chip.
"""

from __future__ import annotations

import contextlib
import dataclasses


def state_unchanged(patch):
    """Every engine iteration returns its models as they came in (its
    counters still advance, so forced runs end)."""
    from cp_cals_tpu_torch.solvers import cals

    made = cals.make_iteration

    def make(*a, **k):
        it = made(*a, **k)

        def step(x, state, *rest):
            return it(x, state, *rest)._replace(kt=state.kt, grams=state.grams)

        step.prepare = it.prepare
        return step

    patch(cals, "make_iteration", make)


def half_the_batch(patch):
    """The engine fits the first half of each rank's models and answers
    the other half from them: every answer has its model's shape, and half
    of them belong to another model."""
    import cp_cals_tpu_torch.solvers as solvers
    from cp_cals_tpu_torch.solvers import cals, jackknife

    fit = cals.cp_cals

    def run(x, queue, params, *a, jk_fibers=None, **k):
        groups: dict[int, list[int]] = {}
        for i, kt in enumerate(queue):
            groups.setdefault(int(kt.rank), []).append(i)
        source = {}  # queue position -> the fitted position that answers it
        for idx in groups.values():
            h = (len(idx) + 1) // 2
            source.update({i: i for i in idx[:h]})
            source.update({i: idx[j % h] for j, i in enumerate(idx[h:])})
        keep = sorted(i for i, s in source.items() if i == s)
        fibers = None if jk_fibers is None else [list(jk_fibers)[i] for i in keep]
        res, rep = fit(x, [queue[i] for i in keep], params, *a, jk_fibers=fibers, **k)
        at = {keep[m.id]: m for m in rep.models}
        rep.models = [dataclasses.replace(at[source[i]], id=i) for i in range(len(queue)) if source[i] in at]
        return [res[keep.index(source[i])] for i in range(len(queue))], rep

    patch(solvers, "cp_cals", run)
    patch(jackknife, "cp_cals", run)


def answer_altered(patch):
    """An eviction round's fetched factors come back with the first row of
    every model's mode-0 factor negated."""
    from cp_cals_tpu_torch.solvers import cals

    split = cals._split_payload

    def altered(raw, layout):
        out = split(raw, layout)
        out[2] = out[2].copy()
        out[2][:, 0] *= -1  # [packed columns, I0]
        return out

    patch(cals, "_split_payload", altered)


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_batch, answer_altered)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place for the block, undone after it."""
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    try:
        FAULTS[name](patch)
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
