"""The bytes of the layouts that the iteration derives from X inside the
loop (the program's counter ``layouts.derived_bytes``: under
``mode_layouts="recompute"`` every MTTKRP derives its mode's layout, and a
CUDA graph's derivations count at each replay) per engine iteration
(``engine_iterations``), over the window. 0 where every layout is held;
None without a trace, and where the program counts no derived layouts
(it has no ``ops.mttkrp.LAYOUTS``)."""

from cals_bench import program_spans


def read(run):
    try:
        from cp_cals_tpu_torch.ops import mttkrp
    except ImportError:
        return None
    rec = program_spans.recorded()
    iters = sum(j.engine_iterations for j in run.jobs)
    if rec is None or not hasattr(mttkrp, "LAYOUTS") or not iters:
        return None
    return rec[1].get("layouts.derived_bytes", 0) / iters
