"""What the forces kernel (`csrc/forces.cu`) takes for granted of the block
plan, and the work counts of ``chip_smoke.py:pair_stats``, on the CPU.

The kernel skips a warp whose 8 centrals are all sentinels, recognised
from ``cen_idx``; it never reads past the tile list; and it neither loads
nor tests a pad group, recognised by its id ``nG``.  Checked on DamBreak3D
at dp 0.06 and on a random scene periodic on the slow axes (the scene of
``tests/test_torch_neighbors.py``).  ``pair_stats`` is held to a
brute-force count that builds each thread's 32-bit range mask as the kernel
does.  No JAX here.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpusph_tpu_torch import BoundaryType, SimParams, setup_framework
from gpusph_tpu_torch.convert import state_from_numpy
from gpusph_tpu_torch.ops.block_plan import (B, GPT, GROUP, PAD_POS, TS,
                                             build_block_plan, plan_dims)
from gpusph_tpu_torch.ops.forces_kernel import prop_table
from gpusph_tpu_torch.ops.neighbors import build_cells, make_grid
from gpusph_tpu_torch.problems.base import get_problem

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import CPW, LANES, WARP, compaction, pair_stats  # noqa: E402
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)


def random_state(seed, n=600, cap=700, box=(0.5, 0.4, 0.3)):
    """Random particles with some dead and disabled slots (numpy)."""
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(0, 1, (cap, 3)) * np.asarray(box)).astype(np.float32)
    info = np.full(cap, 4, np.uint32)  # ParticleType.NONE
    info[:n] = rng.integers(0, 2, n).astype(np.uint32)
    info[rng.choice(n, 20, replace=False)] |= np.uint32(1 << 11)  # FG_INACTIVE
    return dict(pos=pos, vel=np.zeros((cap, 3), np.float32),
                rho=np.zeros(cap, np.float32), mass=np.ones(cap, np.float32),
                info=info, id=np.arange(cap, dtype=np.uint32))


def _dambreak(jostle=False):
    prob = get_problem("DamBreak3D")({"deltap": 0.06})
    grid, state = prob.build()
    fw = prob.fw.finalize()
    if jostle:  # fluid moved off the lattice, so blocks and culls see disorder
        rng = np.random.default_rng(5)
        fluid = (state.info & 7) == 0
        step = torch.from_numpy(rng.normal(0, 0.01, tuple(state.pos.shape)).astype(np.float32))
        state.pos = torch.clamp(state.pos + fluid[:, None] * step, 0.0, 0.59)
    return fw, grid, state


def _random_periodic():
    fw = setup_framework(boundary=BoundaryType.DYN_BOUNDARY,
                         simparams=SimParams(deltap=0.02, max_parts_per_cell=48),
                         periodicity=6).finalize()
    grid = make_grid((0, 0, 0), (0.5, 0.4, 0.3), fw.influenceradius, periodic=6)
    return fw, grid, state_from_numpy(random_state(3, n=1500, cap=1600))


SCENES = {"dambreak": _dambreak, "random_periodic": _random_periodic}


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    fw, grid, state = SCENES[request.param]()
    st, aux = build_cells(grid, state)
    plan = build_block_plan(fw, grid, st, aux)
    return fw, grid, st, plan, prop_table(fw, st)


def test_real_centrals_lead_each_block(scene):
    """Real centrals fill the leading slots of a block, so the kernel's
    warps of sentinels are those past the block's count, recognised from
    cen_idx; every active particle is a central exactly once."""
    _, _, st, plan, _ = scene
    nb, cap = plan.n_blocks, st.capacity
    cen = plan.cen_idx.numpy().reshape(nb + 1, B)
    real = cen < cap
    assert not real[nb].any() and np.all(cen[~real] == cap)
    count = real.sum(axis=1)
    assert np.array_equal(real, np.arange(B)[None, :] < count[:, None])
    sentinel_warp = ~real.reshape(nb + 1, B // CPW, CPW).any(axis=2)
    assert np.array_equal(sentinel_warp, count[:, None] <= CPW * np.arange(B // CPW))
    assert sentinel_warp[:nb].any() and not sentinel_warp[:nb].all()
    act = st.active.numpy()
    assert np.array_equal(np.sort(cen[real]), np.flatnonzero(act))
    slot = plan.slot_of_sorted.numpy()[act]
    assert np.array_equal(cen.ravel()[slot], np.flatnonzero(act))


def test_tile_off_stays_in_the_tile_list(scene):
    """tile_off starts at 0, never decreases and ends inside the list."""
    _, _, _, plan, _ = scene
    off = plan.tile_off.numpy()
    assert off[0] == 0 and np.all(np.diff(off) >= 0)
    assert off[-1] <= plan.flat_groups.shape[0] // GPT == plan.tile_block.shape[0]
    assert (np.diff(off) > 0).any() and (np.diff(off) == 0).any()


def test_pad_group_is_n_groups(scene):
    """Every slot of the tile list names a real group or exactly nG, the
    pad group of the property table (rows at PAD_POS, as is the sentinel
    central's row)."""
    fw, grid, st, plan, P = scene
    nG = plan_dims(fw, grid, st.capacity)["nG"]
    assert P.shape[0] == (nG + 1) * GROUP
    fg = plan.flat_groups.numpy()
    assert fg.min() >= 0 and fg.max() == nG
    used = fg[: int(plan.tile_off[-1]) * GPT]
    assert (used < nG).any() and (used == nG).any()
    assert np.all(fg[int(plan.tile_off[-1]) * GPT:] == nG)
    pos = P[:, :3].numpy()
    assert np.all(pos[nG * GROUP:] == PAD_POS) and np.all(pos[st.capacity] == PAD_POS)


def _brute_force(P, plan, capacity, rad2):
    """pair_stats by explicit per-thread range masks, tile by tile."""
    pos = P[:, :3].numpy()
    nG = P.shape[0] // GROUP - 1
    cen = plan.cen_idx.numpy()
    fg = plan.flat_groups.numpy().reshape(-1, GPT)
    tb = plan.tile_block.numpy()
    bits = 1 << np.arange(TS // LANES, dtype=np.int64)
    out = dict(candidates=0, in_range=0, warp_tiles=0, body_compacted=0, body_slotwise=0)
    for t in range(int(plan.tile_off[-1])):
        rows = cen[tb[t] * B:(tb[t] + 1) * B]
        slots = (fg[t][:, None] * GROUP + np.arange(GROUP)).ravel()  # [TS]
        kept = np.repeat(fg[t] < nG, GROUP)
        d = pos[rows][:, None, :] - pos[slots][None, :, :]
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        hit = (r2 > 0) & (r2 < np.float32(rad2)) & kept[None, :]
        out["candidates"] += int((rows < capacity).sum()) * int(kept.sum())
        out["in_range"] += int(hit.sum())
        for w in range(B * LANES // WARP):
            # thread 4i + lane of warp w: central 8w + i, slots lane + 4j
            threads = [(w * WARP + k) // LANES for k in range(WARP)]
            if not (rows[threads] < capacity).any():
                continue  # the kernel skips a warp of sentinels
            masks = [int((hit[(w * WARP + k) // LANES, k % LANES::LANES] * bits).sum())
                     for k in range(WARP)]
            union = 0
            for m in masks:
                union |= m
            out["warp_tiles"] += 1
            out["body_compacted"] += max(bin(m).count("1") for m in masks)
            out["body_slotwise"] += bin(union).count("1")
    return out


@pytest.mark.parametrize("jostle", [False, True])
def test_pair_stats_match_brute_force(jostle):
    fw, grid, state = _dambreak(jostle)
    st, aux = build_cells(grid, state)
    plan = build_block_plan(fw, grid, st, aux)
    P = prop_table(fw, st)
    rad2 = fw.sp.influenceradius ** 2
    got = pair_stats(P, plan, st.capacity, rad2, chunk=64)
    assert got == _brute_force(P, plan, st.capacity, rad2)
    assert 0 < got["in_range"] < got["candidates"]
    comp = compaction(got)
    assert 0 < comp["mean_popcount"] <= comp["mean_max_popcount"] <= TS // LANES
    assert got["body_compacted"] <= got["body_slotwise"]
    assert 0 < comp["useful_share"] <= 1
