"""The interpreter's garbage collections in the window: the seconds of the
program's ``gc`` spans (every collection, whichever code triggered it,
while the recorder runs), over the window, in percent. None where the
program recorded no spans or no collection (as ``mttkrp_roofline_pct``
is None without MTTKRP kernel time: nothing to read)."""

from cals_bench import program_spans


def read(run):
    rec = program_spans.recorded()
    if rec is None or not rec[1].get("gc.collections"):
        return None
    return 100.0 * program_spans.seconds(rec[0], "gc") / run.window_s
