"""The forces kernel's per-rebuild neighbor structure: the block plan.

Counterpart of ``gpusph_tpu/ops/forces_pallas.py:123-561`` with the same
semantics, so that the same sorted state gives the same plan field for field:

* After the cell sort, particles are grouped into **blocks** of up to ``B=64``
  consecutive sorted particles.  Blocks never straddle cell rows and split
  when their fast-axis span exceeds ``SPAN`` cells, so each block is
  geometrically compact.
* Once per rebuild, the block's 9 candidate runs (3x3 neighbor rows, fast
  span +-1 cell) are culled at ``GROUP=16``-particle granularity with a
  conservative AABB distance test (group box vs the box of the block's
  centrals, threshold ``nlexpansionfactor * influenceradius`` — reference
  `simparams.h:100`), deduplicated, and compacted into a **flat tile list**:
  each tile packs ``GPT=8`` kept groups (128 window slots), and block ``b``
  owns the consecutive tiles ``[tile_off[b], tile_off[b+1])``.
* The list is built from rebuild-time positions and reused by every forces
  pass of the chunk, like the reference's neighbor list
  (`buildneibs_kernel.cu:1029`).

``tile_off`` is the one field the JAX plan lacks: it is the prefix sum of
tiles per block that the JAX ``build_block_plan`` already computes, and it lets a CUDA
block of the forces kernel find its own tiles.  The JAX package's
``GTPU_*`` environment knobs are plain constants here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..framework import SimFramework
from ..state import ParticleState, is_active
from .neighbors import CellAux, CellGrid

B = 64  # central block size
GROUP = 16  # neighbor-list granularity (particles per group)
TS = 128  # window tile width in slots
GPT = TS // GROUP  # groups per window tile
SPAN = 8  # max fast-axis cells per block
PAD_POS = 1.0e4  # pad-slot coordinate: far away, finite in f32 kernels


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class BlockPlan:
    """Per-rebuild neighbor structure (built once per neighbor rebuild,
    reused by every forces pass of the chunk)."""

    flat_groups: torch.Tensor  # i32[T_total*GPT] kept group id per window slot
    tile_block: torch.Tensor  # i32[T_total] owning block per flat tile (pad=nb)
    tile_off: torch.Tensor  # i32[nb+1] first tile of each block (+ end)
    cen_idx: torch.Tensor  # i32[(nb+1)*B] sorted-particle index per central slot
    slot_of_sorted: torch.Tensor  # i32[capacity] central slot per sorted particle
    max_run: torch.Tensor  # i32[] max kept groups (+1e6 on structural overflow)

    @property
    def n_blocks(self) -> int:
        return self.tile_off.shape[0] - 1


def plan_dims(fw: SimFramework, grid: CellGrid, capacity: int):
    """Static plan dimensions for a framework + grid + capacity."""
    sp = fw.sp
    a0, a1, a2 = grid.order
    n0 = grid.ncells[a0]
    n_rows = grid.ncells[a1] * grid.ncells[a2]
    n_cells = grid.n_cells
    K = sp.max_parts_per_cell
    # worst run: a block spans at most SPAN fast-axis cells + one halo cell
    # each side; sp.max_run_extent (probed by Problem.build) bounds it tighter
    ext = sp.max_run_extent if sp.max_run_extent else (SPAN + 2) * K
    GR = ext // GROUP + 2  # candidate groups per run (GROUP-alignment slack)
    M = 9 * GR  # candidate-group list width per block
    nG = -(-capacity // GROUP) if capacity else 1  # groups in the slot array
    # per-block neighbor-list capacity in groups (probed sp.max_block_groups)
    G_max = min(_round_up(sp.max_block_groups or M, GPT), _round_up(M, GPT))
    if capacity:  # can never keep more groups than the whole array holds
        G_max = min(G_max, _round_up(nG + 1, GPT))
    # block-count bound: count splits + span transitions + one per row;
    # problems probe the actual count (sp.max_blocks)
    n_blocks = sp.max_blocks or (capacity // B + n_cells // SPAN + n_rows + 2)
    n_blocks = _round_up(max(n_blocks, 128), 128)
    # flat tile-list capacity: sum over blocks of ceil(kept/GPT), probed
    T_worst = n_blocks * (G_max // GPT)
    T_total = sp.max_flat_tiles or T_worst
    T_total = min(_round_up(max(T_total, 8), 8), T_worst)
    return dict(n0=n0, n_rows=n_rows, GR=GR, M=M, G_max=G_max, nG=nG,
                RMAX=G_max, n_blocks=n_blocks, ext=ext, T_total=T_total)


def probe_plan_numpy(fw: SimFramework, grid: CellGrid, pos) -> dict:
    """Host-side (numpy) probe of the plan geometry on the initial particle
    layout: how many central blocks exist, how many neighbor groups the
    fullest block keeps, and how many flat window tiles the whole list
    needs.  ``Problem.build`` uses it to size ``SimParams.max_blocks`` /
    ``max_block_groups`` / ``max_flat_tiles`` (the analogue of the reference
    sizing its neighbor list from `simparams.h:96` neiblistsize), with an
    evolution margin; runtime overflow still aborts like CHECK_NEIBSNUM.
    """
    sp = fw.sp
    a0, a1, a2 = grid.order
    n0, n1, n2 = grid.ncells[a0], grid.ncells[a1], grid.ncells[a2]
    n_rows = n1 * n2
    n_cells = grid.n_cells

    pos = np.asarray(pos, np.float64)
    org = np.asarray(grid.origin)
    csz = np.asarray(grid.cell_size)
    ncv = np.asarray(grid.ncells)
    ijk = np.clip(np.floor((pos - org) / csz).astype(np.int64), 0, ncv - 1)
    h = (ijk[:, a2] * n1 + ijk[:, a1]) * n0 + ijk[:, a0]
    srt = np.argsort(h, kind="stable")
    h = h[srt]
    p = pos[srt]
    N = len(h)
    if N == 0:
        return dict(max_blocks=128, max_block_groups=GPT,
                    max_run_extent=GROUP, max_flat_tiles=128)

    cs = np.searchsorted(h, np.arange(n_cells + 1))
    rows = np.arange(n_rows + 1)
    row_first = cs[np.minimum(rows * n0, n_cells)]

    # --- block assignment (mirrors build_block_plan) -------------------
    idx = np.arange(N)
    prow = np.minimum(h // n0, n_rows - 1)
    rank = idx - row_first[prow]
    key_cnt = rank // B
    seg = (h % n0) // SPAN
    prev_h = np.concatenate([[-1], h[:-1]])
    same_row = (prev_h // n0 == h // n0) & (prev_h >= 0)
    trans = same_row & (seg != (prev_h % n0) // SPAN)
    tr_cum = np.cumsum(trans)
    tr_excl = tr_cum - trans
    row_tr0 = tr_excl[np.clip(row_first[prow], 0, N - 1)]
    g_local = key_cnt + (tr_cum - row_tr0)
    last = np.clip(row_first[1:] - 1, 0, N - 1)
    firsts = np.clip(row_first[:-1], 0, N - 1)
    row_np = row_first[1:] - row_first[:-1]
    g_per_row = np.where(
        row_np > 0, (row_np - 1) // B + (tr_cum[last] - tr_excl[firsts]) + 1, 0
    )
    row_gbase = np.concatenate([[0], np.cumsum(g_per_row)])
    nb = int(row_gbase[-1])
    g = row_gbase[prow] + g_local

    first_of_g = np.searchsorted(g, np.arange(nb + 1))
    count = np.minimum(np.diff(first_of_g), B)

    # --- candidate runs + group AABB cull ------------------------------
    p0 = np.clip(first_of_g[:-1], 0, N - 1)
    p1 = np.clip(first_of_g[:-1] + count - 1, 0, N - 1)
    c_lo, c_hi = h[p0], h[p1]
    i_lo = np.maximum(c_lo % n0 - 1, 0)
    i_hi = np.minimum(c_hi % n0 + 1, n0 - 1)
    brow = np.minimum(c_lo // n0, n_rows - 1)
    r1_, r2_ = brow % n1, brow // n1

    n_groups = -(-N // GROUP)
    gpad = np.full((n_groups * GROUP - N, 3), np.nan)
    pg = np.concatenate([p, gpad]).reshape(n_groups, GROUP, 3)
    gmin = np.nanmin(pg, axis=1)
    gmax = np.nanmax(pg, axis=1)
    bmin = np.minimum.reduceat(p, first_of_g[:-1])
    bmax = np.maximum.reduceat(p, first_of_g[:-1])
    bc, bh_ = 0.5 * (bmin + bmax), 0.5 * (bmax - bmin)
    gc, gh = 0.5 * (gmin + gmax), 0.5 * (gmax - gmin)

    r_keep = fw.influenceradius * sp.nlexpansionfactor
    L = np.array(grid.world_size)
    per = np.array([bool(fw.periodicbound & (1 << ax)) for ax in range(3)])

    max_ng = 0
    ext = 0
    ng_parts = []
    g0_parts = []
    for d2 in (-1, 0, 1):
        for d1 in (-1, 0, 1):
            c1 = r1_ + d1
            c2 = r2_ + d2
            valid = count > 0
            if fw.periodicbound & (1 << a1):
                c1 = c1 % n1
            else:
                valid = valid & (c1 >= 0) & (c1 < n1)
                c1 = np.clip(c1, 0, n1 - 1)
            if fw.periodicbound & (1 << a2):
                c2 = c2 % n2
            else:
                valid = valid & (c2 >= 0) & (c2 < n2)
                c2 = np.clip(c2, 0, n2 - 1)
            trow = c2 * n1 + c1
            p_start = cs[trow * n0 + i_lo]
            p_end = cs[trow * n0 + i_hi + 1]
            has = valid & (p_end > p_start)
            g0 = p_start // GROUP
            ng = np.where(has, (p_end - 1) // GROUP - g0 + 1, 0)
            max_ng = max(max_ng, int(ng.max(initial=0)))
            ext = max(ext, int(np.max(p_end - p_start, initial=0)))
            g0_parts.append(g0)
            ng_parts.append(ng)
    GRp = max(max_ng, 1)
    giota = np.arange(GRp)
    kept_max = 0
    tiles_total = 0
    CHUNK = 4096  # bound the [CHUNK, 9*GRp] temporaries
    g0a = np.stack(g0_parts, 1)  # [nb, 9]
    nga = np.stack(ng_parts, 1)
    for s in range(0, nb, CHUNK):
        e = min(s + CHUNK, nb)
        cand = g0a[s:e, :, None] + giota[None, None, :]
        live = giota[None, None, :] < nga[s:e, :, None]
        cand = np.where(live, cand, n_groups).reshape(e - s, -1)
        d = np.abs(gc[np.minimum(cand, n_groups - 1)] - bc[s:e, None, :])
        d = np.where(per[None, None, :], np.minimum(d, L - d), d)
        d = np.maximum(d - gh[np.minimum(cand, n_groups - 1)]
                       - bh_[s:e, None, :], 0.0)
        near = (d * d).sum(-1) < r_keep * r_keep
        cand = np.where(near & (cand < n_groups), cand, n_groups)
        cand.sort(axis=1)
        uniq = np.concatenate(
            [np.ones((e - s, 1), bool), cand[:, 1:] != cand[:, :-1]], axis=1
        )
        kept = ((cand < n_groups) & uniq).sum(1)
        kept_max = max(kept_max, int(kept.max(initial=0)))
        tiles_total += int((-(-kept // GPT)).sum())

    return dict(
        max_blocks=_round_up(int(nb * 1.25) + 16, 128),
        max_block_groups=_round_up(int(kept_max * 1.3) + 2, GPT),
        max_run_extent=_round_up(int(ext * 1.15) + GROUP, 8),
        max_flat_tiles=_round_up(int((tiles_total + nb) * 1.3) + 64, 8),
    )


def build_block_plan(fw: SimFramework, grid: CellGrid, state: ParticleState,
                     aux: CellAux) -> BlockPlan:
    """Build the block layout and the flat packed neighbor-tile list from
    the *sorted* state and its cell tables (the NEIBS_LIST phase,
    `buildneibs.cu:358-450`).

    Index arithmetic runs in int64 on the state's device; the returned
    index arrays are int32, as the CUDA kernel takes them.
    """
    dev = state.pos.device
    i64 = dict(dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    capacity = state.capacity
    d = plan_dims(fw, grid, capacity)
    n0, n_rows, GR, M = d["n0"], d["n_rows"], d["GR"], d["M"]
    n_blocks, nG, T_total = d["n_blocks"], d["nG"], d["T_total"]
    a0, a1, a2 = grid.order
    n1 = grid.ncells[a1]
    n2 = grid.ncells[a2]
    n_cells = grid.n_cells

    cs = aux.cell_start.long()  # [n_cells+2]
    hs = aux.hash_sorted.long()
    rows = torch.arange(n_rows + 1, **i64)
    row_first = cs[torch.clamp(rows * n0, max=n_cells)]  # [n_rows+1]

    # --- block assignment per sorted particle -------------------------------
    # Within a row, a new block starts every B particles OR when the
    # fast-axis SPAN segment changes between consecutive particles (a dense
    # span key: empty segments produce no dead block ids).  Blocks never
    # cross rows.
    idx = torch.arange(capacity, **i64)
    h = hs[:capacity]
    active = h < n_cells
    prow = torch.clamp(h // n0, max=n_rows - 1)
    rank_in_row = idx - row_first[prow]
    key_cnt = rank_in_row // B
    seg = (h % n0) // SPAN
    prev_h = torch.cat([torch.full((1,), -1, **i64), h[:-1]])
    same_row = (prev_h // n0 == h // n0) & (prev_h >= 0)
    trans = (active & same_row & (seg != (prev_h % n0) // SPAN)).long()
    tr_cum = torch.cumsum(trans, 0)  # inclusive
    tr_excl = tr_cum - trans
    row_tr0 = tr_excl[torch.clamp(row_first[prow], 0, capacity - 1)]
    g_local = key_cnt + (tr_cum - row_tr0)

    last = torch.clamp(row_first[1:] - 1, 0, capacity - 1)  # last particle/row
    firsts = torch.clamp(row_first[:-1], 0, capacity - 1)
    row_np = row_first[1:] - row_first[:-1]
    g_per_row = torch.where(
        row_np > 0, (row_np - 1) // B + (tr_cum[last] - tr_excl[firsts]) + 1, 0)
    row_gbase = torch.cat([torch.zeros(1, **i64), torch.cumsum(g_per_row, 0)])
    blocks_used = row_gbase[-1]
    g = torch.where(active, torch.clamp(row_gbase[prow] + g_local, max=n_blocks),
                    n_blocks)

    # first/last particle per block (g is non-decreasing)
    blk_ids = torch.arange(n_blocks + 1, **i64)
    first_all = torch.searchsorted(g, blk_ids)
    end_of_g = first_all[1:]
    first_of_g = first_all[:-1]
    count = torch.clamp(end_of_g - first_of_g, max=B)

    slot_of_sorted = torch.where(
        active, g * B + (idx - first_of_g[torch.clamp(g, max=n_blocks - 1)]),
        n_blocks * B - 1)
    slot_of_sorted = torch.clamp(slot_of_sorted, 0, n_blocks * B - 1)

    # sorted particle (or sentinel=capacity) of each central slot; the
    # trailing dummy block is all-sentinel
    slots = torch.arange((n_blocks + 1) * B, **i64)
    sg = torch.clamp(slots // B, max=n_blocks - 1)
    in_g = slots - (slots // B) * B
    cen_idx = torch.where((slots < n_blocks * B) & (in_g < count[sg]),
                          first_of_g[sg] + in_g, capacity)

    # --- 9 candidate runs per block (3x3 neighbor rows x fast span +-1) -----
    nonempty = count > 0
    p0 = torch.clamp(first_of_g, 0, capacity - 1)
    p1 = torch.clamp(first_of_g + count - 1, 0, capacity - 1)
    c_lo = torch.where(nonempty, hs[p0], 0)
    c_hi = torch.where(nonempty, hs[p1], 0)
    i_lo = torch.clamp(c_lo % n0 - 1, min=0)
    i_hi = torch.clamp(c_hi % n0 + 1, max=n0 - 1)
    brow = torch.clamp(c_lo // n0, max=n_rows - 1)
    r1 = brow % n1  # a1 coordinate of the block's row
    r2 = brow // n1  # a2 coordinate

    GBIG = nG  # sentinel: one past the last real group
    giota = torch.arange(GR, **i64)[None, :]
    cands = []
    max_ng = torch.zeros((), **i64)
    for d2 in (-1, 0, 1):
        for d1 in (-1, 0, 1):
            c1 = r1 + d1
            c2 = r2 + d2
            valid = nonempty
            if fw.periodicbound & (1 << a1):
                c1 = c1 % n1
            else:
                valid = valid & (c1 >= 0) & (c1 < n1)
                c1 = torch.clamp(c1, 0, n1 - 1)
            if fw.periodicbound & (1 << a2):
                c2 = c2 % n2
            else:
                valid = valid & (c2 >= 0) & (c2 < n2)
                c2 = torch.clamp(c2, 0, n2 - 1)
            trow = c2 * n1 + c1
            p_start = cs[trow * n0 + i_lo]
            p_end = cs[trow * n0 + i_hi + 1]
            has = valid & (p_end > p_start)
            g0 = p_start // GROUP
            ng = torch.where(has, (p_end - 1) // GROUP - g0 + 1, 0)
            max_ng = torch.maximum(max_ng, ng.max())
            cands.append(torch.where(giota < ng[:, None], g0[:, None] + giota,
                                     GBIG))
    cand = torch.cat(cands, dim=1)  # [n_blocks, M]

    # --- dedup (runs from adjacent rows can straddle one group) -------------
    cand = torch.sort(cand, dim=1).values
    uniq = torch.cat([torch.ones((n_blocks, 1), dtype=torch.bool, device=dev),
                      cand[:, 1:] != cand[:, :-1]], dim=1)

    # --- conservative AABB cull at GROUP granularity -------------------------
    # keep a group iff its active-particle bounding box comes within r_keep
    # of the box of the block's centrals (rebuild-time positions; reference
    # nlInfluenceRadius, simparams.h:101).  Inactive rows are parked at
    # PAD_POS in the property table and fail the kernel's r2 test.
    r_keep = fw.influenceradius * fw.sp.nlexpansionfactor
    r_keep2 = torch.tensor(r_keep * r_keep, **f32)
    act_col = is_active(state.info)[:, None]
    inf = float("inf")
    pos_lo = torch.where(act_col, state.pos, inf)
    pos_hi = torch.where(act_col, state.pos, -inf)
    pad_rows = nG * GROUP - capacity
    gmin = torch.cat([pos_lo, torch.full((pad_rows, 3), inf, **f32)]
                     ).reshape(nG, GROUP, 3).amin(dim=1)
    gmax = torch.cat([pos_hi, torch.full((pad_rows, 3), -inf, **f32)]
                     ).reshape(nG, GROUP, 3).amax(dim=1)
    gbox = torch.cat([0.5 * (gmin + gmax), 0.5 * (gmax - gmin)], dim=1)  # [nG,6]

    pos_pad = torch.cat([torch.where(act_col, state.pos, PAD_POS),
                         torch.full((1, 3), PAD_POS, **f32)], dim=0)
    cpos = pos_pad[cen_idx[: n_blocks * B]].reshape(n_blocks, B, 3)
    cvalid = (torch.arange(B, **i64)[None, :] < count[:, None])[:, :, None]
    bmin = torch.where(cvalid, cpos, inf).amin(dim=1)
    bmax = torch.where(cvalid, cpos, -inf).amax(dim=1)
    bc = 0.5 * (bmin + bmax)
    bh = 0.5 * (bmax - bmin)

    gb = gbox[torch.clamp(cand, max=nG - 1)]  # [nb, M, 6]
    dctr = torch.abs(gb[..., :3] - bc[:, None, :])
    L = torch.tensor(grid.world_size, **f32)
    per_mask = torch.tensor(
        [fw.periodicbound & (1 << ax) != 0 for ax in range(3)], device=dev)
    dctr = torch.where(per_mask, torch.minimum(dctr, L - dctr), dctr)
    dbox = torch.maximum(dctr - gb[..., 3:] - bh[:, None, :],
                         torch.zeros((), **f32))
    dist2 = (dbox[..., 0] * dbox[..., 0] + dbox[..., 1] * dbox[..., 1]
             + dbox[..., 2] * dbox[..., 2])
    near = dist2 < r_keep2
    keep = near & uniq & (cand < GBIG)

    # --- compact to the flat packed tile list -------------------------------
    key = torch.where(keep, cand, GBIG)
    win_groups = torch.sort(key, dim=1).values  # kept (asc) then GBIG pads
    kept = keep.sum(dim=1)
    tiles_b = -(-kept // GPT)  # ceil
    off = torch.cat([torch.zeros(1, **i64), torch.cumsum(tiles_b, 0)])  # [nb+1]
    t_used = off[-1]

    t_ids = torch.arange(T_total, **i64)
    # pad tiles (t >= t_used) -> n_blocks (the dummy block)
    tile_block = torch.clamp(torch.searchsorted(off, t_ids, right=True) - 1,
                             max=n_blocks)

    s_ids = torch.arange(T_total * GPT, **i64)
    ts = s_ids // GPT
    js = s_ids - ts * GPT
    bs = tile_block[ts]
    bcl = torch.clamp(bs, max=n_blocks - 1)
    gi = (ts - off[bcl]) * GPT + js
    gi_cl = torch.clamp(gi, 0, M - 1)
    wg = win_groups[bcl, gi_cl]
    live = (bs < n_blocks) & (gi >= 0) & (gi < kept[bcl])
    flat_groups = torch.where(live, wg, GBIG)

    # structural overflows surface like CHECK_NEIBSNUM (GPUSPH.cc:1851):
    # block table full, a run longer than the probed extent, or the flat
    # tile list overflowing its capacity; kept > G_max is caught by max_run
    # itself.  On overflow the tile list holds the first T_total tiles, and
    # tile_off is clamped to them so the kernel never reads past the list.
    overflow = ((blocks_used > n_blocks) | (max_ng > GR) | (t_used > T_total)).long()
    max_run = torch.maximum(kept.max(), overflow * 1_000_000)

    i32 = torch.int32
    return BlockPlan(
        flat_groups=flat_groups.to(i32),
        tile_block=tile_block.to(i32),
        tile_off=torch.clamp(off, max=T_total).to(i32),
        cen_idx=cen_idx.to(i32),
        slot_of_sorted=slot_of_sorted.to(i32),
        max_run=max_run.to(i32),
    )


__all__ = [
    "BlockPlan",
    "build_block_plan",
    "plan_dims",
    "probe_plan_numpy",
    "B",
    "GROUP",
    "TS",
    "GPT",
    "SPAN",
    "PAD_POS",
]
