"""The tensor-core MTTKRP's grid (``csrc/fused_mttkrp_tc.cu``) as
``ops/fused_mttkrp.py:plan_tc`` plans it, j split over one wave or, where
that leaves block slots idle, over several (``tc_cost``), on the CPU.

``blocks`` maps every block of a plan's grid to its tile, split and output
as the kernel does. The tests hold that every (tile, j, k range) is
covered exactly once, for the ``cube500.select50_high`` cell's launches,
the ``fluor`` cells' and edge shapes; that the busiest block slot's j
steps are the ones PERF.md gives for ``cube500``; that the planner keeps
the one-wave plan wherever that wave already fills the card; and that the
partial sums, taken in float64 in the grid's order, give the plain
version's result.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.profiles.tune_pallas_mttkrp import H100

SLOTS_500_HIGH = H100.n_sm  # one block an SM: U2's slice fills its shared memory


def blocks(plan, j: int, i: int, kp: int, c: int) -> list[dict]:
    """Every block of the grid of tensor-core ``plan`` in launch order
    (column tiles fastest, then row tiles, then splits): its tile, split z,
    j range, k range and output ("G", or split ``z`` of the workspace), as
    ``mttkrp_tc_kernel`` maps ``blockIdx``."""
    nc, kspan, ksplits, jsplits, jchunk = plan
    tiles, splits = -(-c // nc) * -(-i // 64), ksplits * jsplits
    k64 = -(-kp // 64) * 64
    out = []
    for z in range(splits):
        for tile in range(tiles):
            j0, k0 = (z // ksplits) * jchunk, (z % ksplits) * kspan
            nk = max(0, min(kspan, k64 - k0)) // 64 * 64
            nj = min(j, j0 + jchunk) - j0 if nk else 0
            out.append(dict(tile=tile, z=z, j0=j0, nj=nj, k0=k0, nk=nk, dest="G" if splits == 1 else z))
    return out


def assert_covers(plan, j: int, i: int, kp: int, c: int) -> None:
    """Every (tile, j, 64-k chunk) once; no empty block."""
    tiles = -(-c // plan[0]) * -(-i // 64)
    seen = np.zeros((tiles, j, -(-kp // 64)), dtype=int)
    for b in blocks(plan, j, i, kp, c):
        assert b["nj"] > 0 and b["nk"] > 0, b
        seen[b["tile"], b["j0"]:b["j0"] + b["nj"], b["k0"] // 64:(b["k0"] + b["nk"]) // 64] += 1
    assert (seen == 1).all(), plan


def card_plan(shape, mode: int, c: int, tier: str, card=H100):
    """The H100's plan, the one-wave plan it was chosen against, the block
    slots, and (J, I, Kp)."""
    small, big = fm.split_others(shape, mode)
    j, i, k = shape[small], shape[mode], shape[big]
    kp, planes = fm.padded_k(k), fm.PLANES[tier]
    plan = fm.plan_tc(j, i, kp, c, planes, card.n_sm, card.smem_block, card.smem_sm)
    slots = fm.tc_slots(plan[0], planes, plan[1], card.n_sm, card.smem_sm)
    return plan, fm.one_wave_tc(plan[:3], j, i, c, slots), slots, (j, i, kp)


def busiest(plan, i: int, c: int, slots: int) -> int:
    """j steps of the busiest block slot: a wave lasts its longest block."""
    return fm.tc_waves(plan, i, c, slots) * plan[4]


# cube500.select50_high's launches at "high": (B, R) -> the busiest slot's
# j steps on one wave (the parent's plan), planned, and spread evenly over
# the 132 SMs (ceil(tiles * J / 132)), with the bucket-iterations of a job
# (PERF.md §6).
CUBE500 = {
    (96, 4): (250, 184, 182, 50),
    (96, 8): (500, 375, 364, 50),
    (64, 16): (500, 500, 485, 100),
    (32, 16): (250, 250, 243, 50),
    (64, 20): (1000, 625, 607, 50),
    (16, 20): (167, 167, 152, 50),
}
# The fluor cells' launches on 299 x 301 x 41: bench select's buckets, the
# jackknife's bucket and its compacted tails, at both bf16 tiers.
FLUOR_C = (96 * 4, 64 * 8, 64 * 12, 32 * 16, 32 * 20, 320 * 8, 160 * 8, 80 * 8)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("br", sorted(CUBE500))
def test_cube500_launches_cover_their_work_once(mode, br):
    b, r = br
    plan, wave, _, (j, i, kp) = card_plan((500, 500, 500), mode, b * r, "high")
    assert_covers(plan, j, i, kp, b * r)
    assert_covers(wave, j, i, kp, b * r)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("br", sorted(CUBE500))
def test_cube500_busiest_slot(mode, br):
    """The busiest slot's j steps: one wave's (the lone second wave of
    bucket 20's 160 tiles costs a full one), the planner's, and the even
    spread that the planner's splits, where it takes more waves, come
    within 4 % of."""
    b, r = br
    parent, mine, even, _ = CUBE500[br]
    plan, wave, slots, (j, i, kp) = card_plan((500, 500, 500), mode, b * r, "high")
    assert slots == SLOTS_500_HIGH
    assert busiest(wave, i, b * r, slots) == parent
    assert busiest(plan, i, b * r, slots) == mine
    assert -(-(-(-b * r // plan[0]) * -(-i // 64)) * j // slots) == even
    assert (plan != wave) == (mine < parent)
    if plan != wave:
        assert mine <= 1.04 * even


def test_cube500_job_cost_and_balanced_share():
    """A job's MTTKRP in busiest-slot j steps (bucket-iterations times
    three modes): 158,350 on one wave, 130,050 planned (a 1.22x cut),
    125,900 spread evenly; three in seven launches over several waves."""
    weights = {br: v[3] for br, v in CUBE500.items()}
    assert sum(weights[br] * v[0] for br, v in CUBE500.items()) == 158_350
    assert sum(weights[br] * v[1] for br, v in CUBE500.items()) == 130_050
    assert sum(weights[br] * v[2] for br, v in CUBE500.items()) == 125_900
    balanced = launches = 0
    for (b, r), w in weights.items():
        for mode in range(3):
            plan, wave, slots, (_, i, _) = card_plan((500, 500, 500), mode, b * r, "high")
            launches += w
            balanced += w * (plan[3] > 1 and fm.tc_waves(plan, i, b * r, slots) > 1)
    assert (balanced, launches) == (450, 1050)


@pytest.mark.parametrize("tier", ["default", "high"])
@pytest.mark.parametrize("c", FLUOR_C)
def test_fluor_launches_keep_the_one_wave_plan(tier, c):
    """The fluor cells' launches keep the parent's one-wave plan (their
    grids fill the card, or more waves would not pay their blocks)."""
    for mode in range(3):
        plan, wave, _, (j, i, kp) = card_plan((299, 301, 41), mode, c, tier)
        assert plan == wave
        assert_covers(plan, j, i, kp, c)


@pytest.mark.parametrize("tier", ["default", "high"])
@pytest.mark.parametrize("b,r,modes,plan", [
    (96, 20, (0, 1), (128, 320, 1, 3, 14)),
    (192, 20, (0, 1), (128, 320, 1, 3, 14)),
    (320, 20, (2,), (128, 320, 1, 5, 60)),
])
def test_timed_299x301x41_launches_take_more_waves(tier, b, r, modes, plan):
    """The launches PERF.md §6 times at 299x301x41 that the planner splits
    over several waves (17-19 % faster on the card than one wave), and the
    other modes of the same (B, R), which keep one wave."""
    for mode in range(3):
        mine, wave, slots, (j, i, kp) = card_plan((299, 301, 41), mode, b * r, tier)
        assert (mine == plan) == (mode in modes)
        assert (mine != wave) == (mode in modes)
        assert_covers(mine, j, i, kp, b * r)


# Edge shapes (J, I, Kp, C) with plans: J = 1, C below the column tile, k
# split, a single tile, ragged row and column tiles, several waves.
EDGE_PLANS = [
    ((1, 300, 64, 40), (64, 64, 1, 1, 1)),
    ((9, 70, 128, 20), (32, 128, 1, 3, 3)),
    ((9, 70, 128, 20), (32, 128, 1, 1, 9)),
    ((7, 130, 3008, 35), (64, 512, 6, 2, 4)),
    ((7, 130, 3008, 35), (64, 512, 6, 1, 7)),
    ((5, 64, 64, 128), (128, 64, 1, 5, 1)),
    ((13, 200, 320, 300), (128, 320, 1, 4, 4)),
    ((13, 200, 320, 300), (128, 320, 1, 1, 13)),
    ((41, 150, 304, 220), (64, 320, 1, 7, 6)),
]


@pytest.mark.parametrize("shape,plan", EDGE_PLANS)
def test_edge_plans_cover_their_work_once(shape, plan):
    j, i, kp, c = shape
    assert fm.check_tc_plan(plan, j, i, kp, 2, H100.smem_block) == plan
    assert_covers(plan, j, i, kp, c)


@pytest.mark.parametrize("j", [1, 7, 41, 300])
@pytest.mark.parametrize("i", [20, 301, 500, 3000])
@pytest.mark.parametrize("c", [5, 64, 320, 1280, 2560])
def test_planner_keeps_one_wave_where_it_fills_the_card(j, i, c):
    """Where the one-wave plan's blocks fill 93 % or more of its waves'
    slots, the planner returns it; any plan it returns costs no more
    (``tc_cost``), covers the work once and passes the validator."""
    for planes in (1, 2):
        kp = fm.padded_k(499)
        plan = fm.plan_tc(j, i, kp, c, planes, H100.n_sm, H100.smem_block, H100.smem_sm)
        slots = fm.tc_slots(plan[0], planes, plan[1], H100.n_sm, H100.smem_sm)
        wave = fm.one_wave_tc(plan[:3], j, i, c, slots)
        n_blocks = -(-c // wave[0]) * -(-i // 64) * wave[2] * wave[3]
        if n_blocks >= fm._TC_MARGIN * slots * -(-n_blocks // slots):
            assert plan == wave
        assert fm.tc_cost(plan, i, c, slots) <= fm.tc_cost(wave, i, c, slots)
        if plan != wave:
            assert fm.tc_cost(plan, i, c, slots) < fm._TC_MARGIN * fm.tc_cost(wave, i, c, slots)
        assert fm.check_tc_plan(plan, j, i, kp, planes, H100.smem_block) == plan
        if j * i <= 41 * 500:
            assert_covers(plan, j, i, kp, c)


def test_tc_cost_counts_waves_and_blocks():
    """Bucket 20 at 500^3 "high": 160 tiles on 132 slots; one wave's plan
    takes two (the second 28 blocks alone), four splits five."""
    assert fm.tc_waves((64, 512, 1, 1, 500), 500, 1280, 132) == 2
    assert fm.tc_cost((64, 512, 1, 1, 500), 500, 1280, 132) == 2 * (500 * 8 + fm._TC_BLOCK_STAGES)
    assert fm.tc_waves((64, 512, 1, 4, 125), 500, 1280, 132) == 5
    assert fm.tc_cost((64, 512, 1, 4, 125), 500, 1280, 132) == 5 * (125 * 8 + fm._TC_BLOCK_STAGES)
    assert fm.one_wave_tc((64, 512, 1), 500, 500, 1280, 132) == (64, 512, 1, 1, 500)
    assert fm.one_wave_tc((64, 512, 1), 500, 500, 384, 132) == (64, 512, 1, 2, 250)
    assert fm.split_j((64, 512, 1), 500, 11) == (64, 512, 1, 11, 46)


def _bf16_values(rng, shape):
    return torch.from_numpy(rng.normal(size=shape)).to(torch.bfloat16).double()


def emulate(plan, x3: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """G [B, I, R] summed in float64 as the plan's grid sums it: each block
    its j range of its tile, sum_j U1[j] * (X_j U2) over its k range;
    unsplit tiles written, splits added up in split order
    (reduce_splits)."""
    b, j, r = u1.shape
    _, i, k = x3.shape
    c, nc = b * r, plan[0]
    nct, nrt = -(-c // nc), -(-i // 64)
    kp = -(-k // 8) * 8
    k64 = -(-kp // 64) * 64
    xp = torch.zeros((j, nrt * 64, k64), dtype=torch.float64)
    xp[:, :i, :k] = x3
    up1 = torch.zeros((j, nct * nc), dtype=torch.float64)
    up1[:, :c] = u1.permute(1, 0, 2).reshape(j, c)
    up2 = torch.zeros((k64, nct * nc), dtype=torch.float64)
    up2[:k, :c] = u2.permute(1, 0, 2).reshape(k, c)
    g = torch.full((nrt * 64, nct * nc), float("nan"), dtype=torch.float64)
    parts: dict = {}
    for blk in blocks(plan, j, i, kp, c):
        rows = slice((blk["tile"] // nct) * 64, (blk["tile"] // nct + 1) * 64)
        cols = slice((blk["tile"] % nct) * nc, (blk["tile"] % nct + 1) * nc)
        ks = slice(blk["k0"], blk["k0"] + blk["nk"])
        acc = torch.zeros((64, nc), dtype=torch.float64)
        for jj in range(blk["j0"], blk["j0"] + blk["nj"]):
            acc = acc + (xp[jj, rows, ks] @ up2[ks, cols]) * up1[jj, cols]
        if blk["dest"] == "G":
            g[rows, cols] = acc
        else:
            parts.setdefault(blk["tile"], []).append((blk["z"], acc))
    for tile, got in parts.items():
        rows = slice((tile // nct) * 64, (tile // nct + 1) * 64)
        cols = slice((tile % nct) * nc, (tile % nct + 1) * nc)
        s = torch.zeros((64, nc), dtype=torch.float64)
        for _, p in sorted(got, key=lambda zp: zp[0]):
            s = s + p
        g[rows, cols] = s
    return g[:i, :c].reshape(i, b, r).permute(1, 0, 2)


@pytest.mark.parametrize("shape,plan", EDGE_PLANS + [
    ((41, 150, 304, 220), (64, 320, 1, 3, 14)),
    ((41, 150, 304, 220), (64, 320, 1, 1, 41)),
])
def test_schedule_sums_in_float64_match_plain(shape, plan):
    """On bf16 values, where the plain version's rounding is exact, the
    grid's float64 partial sums give ``fused_mttkrp_plain`` at 1e-12."""
    j, i, kp, c = shape
    rng = np.random.default_rng(j * i + c)
    r = next(rr for rr in (5, 4, 7, 1) if c % rr == 0)
    b, k = c // r, kp - 3 if kp > 8 else kp
    x3 = _bf16_values(rng, (j, i, k))
    u1, u2 = _bf16_values(rng, (b, j, r)), _bf16_values(rng, (b, k, r))
    want = fm.fused_mttkrp_plain(x3, u1, u2, "default")
    got = emulate(plan, x3, u1, u2)
    assert got.shape == want.shape == (b, i, r)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-12 * scale


@pytest.mark.parametrize("plan", [
    (64, 512, 1, 2, 250, -1),
    (64, 512, 1, 11, 46, 0),
    (64, 512, 1, 2),
    (64, 512, 1, 2, 250.5),
])
def test_tc_plan_validator_takes_five_integers(plan):
    with pytest.raises(ValueError, match="five integers"):
        fm.check_tc_plan(plan, 500, 500, 504, 2, H100.smem_block)
