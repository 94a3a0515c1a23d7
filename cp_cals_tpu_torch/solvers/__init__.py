from .als import AlsReport, cp_als, cp_batched_als
from .cals import CalsModelReport, CalsReport, cp_cals, release_graphs
from .jackknife import (
    JKReport,
    jackknife_norms,
    jk_cp_als,
    jk_cp_batched_als,
    jk_cp_cals,
    jk_permutation_adjustment,
)
