"""The CUDA graphs' capture share: the seconds of the program's
``loop.capture`` spans (each graph's eager first call and its capture,
made anew in every engine call), over the jobs' summed walls, in percent.
None where the program recorded no spans, and on a run without a card,
where nothing is captured."""

import torch

from cals_bench import program_spans


def read(run):
    rec = program_spans.recorded()
    if rec is None or not torch.cuda.is_available():
        return None
    return 100.0 * program_spans.seconds(rec[0], "loop.capture") / sum(j.wall_s for j in run.jobs)
