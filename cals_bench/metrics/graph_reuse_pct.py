"""The CUDA graphs that the chunk loops took from earlier engine calls: of
every graph a loop ran in the window, the share it took kept (the
program's counter ``graphs.reused``) rather than captured (``captures``),
in percent. None where the program counts no kept graphs (it keeps
none), and on a run without a card, where nothing is captured or kept."""

from cals_bench import program_spans


def read(run):
    rec = program_spans.recorded()
    if rec is None or "graphs.reused" not in rec[1]:
        return None
    reused, captured = rec[1]["graphs.reused"], rec[1].get("captures", 0)
    return 100.0 * reused / (reused + captured) if reused + captured else None
