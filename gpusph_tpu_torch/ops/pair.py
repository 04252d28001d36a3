"""Dense cell-pair interaction combinator: the general neighbor loop.

Counterpart of the JAX package's ``ops/pair.py`` (the reference iterates a
per-thread neighbor list, `src/cuda/neibs_iteration.cuh:80-320`).  Whole
cells are processed against their 27 neighbor cells as dense masked blocks:

* centrals of a cell: the ``K = max_parts_per_cell`` slots of its sorted slice
* neighbor candidates: the ``27*K`` slots of the neighboring cells' slices

Each chunk of ``C`` cells yields ``[C, K, 27K]`` pair blocks on which the
physics callback computes its pairwise terms with plain tensor math; the
chunks run one after another, so memory stays bounded.  Every field is a
scalar component (``pos_x``, ``pos_y``, ``pos_z``), as in the JAX package.

The general forces pass (`ops/forces.py`, for configurations outside the
forces kernel's), Grenier's density pass, the filters, the viscosity
engine, the write-time post-process passes and the repacking forces use it.
The forces pass of the kernel configurations does not: it runs the
hand-written kernel (`ops/forces_kernel.py`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .neighbors import CellAux, CellGrid, neighbor_cell_ids

# pair slots of one chunk: C * K * 27K <= 2**24 on the card, so each f32
# pair tensor of a chunk takes at most 64 MiB (DamBreak3D at dp 0.012 builds
# K = 72: 119 cells per chunk); on the CPU 2**20 (4 MiB, which the caches
# hold: a Jacobi solve of LithostaticDYN at dp 0.1 took 4.6 s against 16.2 s
# with 2**24, on an 8-core x86 host).  A central's sum does not depend on the
# chunking.
PAIR_SLOTS_PER_CHUNK = 1 << 24
CPU_PAIR_SLOTS_PER_CHUNK = 1 << 20


def split_vec(name: str, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Split an [N,3] tensor into scalar components {name_x, name_y, name_z}."""
    return {f"{name}_x": v[:, 0], f"{name}_y": v[:, 1], f"{name}_z": v[:, 2]}


def merge_vec(out: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """Re-assemble an [N,3] tensor from scalar component outputs."""
    return torch.stack([out[f"{name}_x"], out[f"{name}_y"], out[f"{name}_z"]], dim=-1)


def min_image(grid: CellGrid, device) -> Callable:
    """``wrap(rel, axis)``: a relative position along ``axis`` taken to its
    nearest periodic image on the grid's periodic axes (unchanged on the
    others)."""
    f32 = dict(dtype=torch.float32, device=device)
    per = int(grid.periodic)
    wraps = [(torch.tensor(L, **f32), torch.tensor(1.0 / L, **f32))
             if per & (1 << a) else None for a, L in enumerate(grid.world_size)]

    def wrap(rel, axis):
        if wraps[axis] is None:
            return rel
        L, inv_L = wraps[axis]
        return rel - L * torch.round(rel * inv_L)

    return wrap


class PairGeometry:
    """Per-pair geometry handed to the physics callback (all [C,K,NB])."""

    __slots__ = ("relx", "rely", "relz", "r2", "r", "mask")

    def __init__(self, relx, rely, relz, r2, r, mask):
        self.relx = relx
        self.rely = rely
        self.relz = relz
        self.r2 = r2
        self.r = r
        self.mask = mask

    def dot_rel(self, x, y, z):
        """Dot product of a per-pair vector with the relative position."""
        return x * self.relx + y * self.rely + z * self.relz


def neighbor_apply(
    grid: CellGrid,
    aux: CellAux,
    fields: Dict[str, torch.Tensor],
    pair_fn: Callable,
    *,
    max_parts_per_cell: int,
    influenceradius: float,
    out_capacity: Optional[int] = None,
    cells: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Apply ``pair_fn`` over all neighbor pairs and sum per central particle.

    Args:
      fields: dict of per-particle [N] scalar tensors in the rebuild's sorted
        order; must contain ``pos_x/pos_y/pos_z``.
      pair_fn: ``pair_fn(central, neib, geom) -> dict`` with
        ``central[name]`` [C,K,1], ``neib[name]`` [C,1,NB] (pre-expanded for
        broadcasting) and ``geom`` a :class:`PairGeometry`.  Output values are
        [C,K,NB] per-pair terms, summed over NB; pair_fn must itself zero
        every output outside ``geom.mask``.  Keys prefixed ``min_`` reduce
        with min instead of sum (pair_fn emits +inf on invalid pairs for
        those).
      cells: the linear ids of the cells whose centrals to visit (default:
        every cell that holds a particle).  Centrals of other cells get 0
        (+inf for ``min_``).

    Returns dict of [out_capacity or N] per-particle results in sorted order.
    """
    K = max_parts_per_cell
    n_cells = grid.n_cells
    px = fields["pos_x"]
    dev = px.device
    out_n = px.shape[0] if out_capacity is None else out_capacity
    if cells is None:
        # empty cells have no centrals: skip them (waits for the device)
        cells = torch.nonzero(aux.cell_count[:n_cells]).squeeze(1)
    cells = cells.long()
    NB = 27 * K
    slots = CPU_PAIR_SLOTS_PER_CHUNK if dev.type == "cpu" else PAIR_SLOTS_PER_CHUNK
    C = max(1, slots // (K * NB))  # cells per chunk

    f32 = dict(dtype=torch.float32, device=dev)
    k_ar = torch.arange(K, device=dev)
    rad2 = torch.tensor(influenceradius * influenceradius, **f32)
    cell_start = aux.cell_start.long()

    wrap = min_image(grid, dev)  # periodic minimum image, per scalar axis

    results: Dict[str, torch.Tensor] = {}
    # at least one chunk, possibly empty, so that every output key exists
    for c0 in range(0, max(cells.shape[0], 1), C):
        cc = cells[c0:c0 + C]
        start = cell_start[cc]  # [C]
        count = aux.cell_count[cc]
        cidx = start[:, None] + k_ar[None, :]  # [C,K]
        cmask = k_ar[None, :] < count[:, None]
        cidx_safe = torch.where(cmask, cidx, 0)

        neib_lin = neighbor_cell_ids(grid, cc)  # [C,27], trash cell if outside
        nstart = cell_start[neib_lin]
        ncount = torch.where(neib_lin < n_cells, aux.cell_count[neib_lin], 0)
        nidx = nstart[:, :, None] + k_ar[None, None, :]  # [C,27,K]
        nmask = k_ar[None, None, :] < ncount[:, :, None]
        nidx = torch.where(nmask, nidx, 0).reshape(-1, NB)
        nmask = nmask.reshape(-1, NB)

        central = {k: v[cidx_safe][:, :, None] for k, v in fields.items()}
        neib = {k: v[nidx][:, None, :] for k, v in fields.items()}

        relx = wrap(central["pos_x"] - neib["pos_x"], 0)
        rely = wrap(central["pos_y"] - neib["pos_y"], 1)
        relz = wrap(central["pos_z"] - neib["pos_z"], 2)
        r2 = relx * relx + rely * rely + relz * relz

        mask = (
            cmask[:, :, None]
            & nmask[:, None, :]
            & (r2 < rad2)
            & (cidx[:, :, None] != nidx[:, None, :])  # exclude self
        )
        geom = PairGeometry(relx, rely, relz, r2, torch.sqrt(r2), mask)

        # centrals past out_capacity and empty slots land in the dropped
        # slot out_n (every real central sits in exactly one cell)
        sidx = torch.where(cmask & (cidx < out_n), cidx, out_n).reshape(-1)
        for name, v in pair_fn(central, neib, geom).items():
            is_min = name.startswith("min_")
            red = v.amin(dim=2) if is_min else v.sum(dim=2)  # [C,K]
            if name not in results:
                results[name] = torch.full((out_n + 1,), torch.inf if is_min else 0.0,
                                           dtype=red.dtype, device=dev)
            results[name][sidx] = red.reshape(-1)
    return {k: v[:out_n] for k, v in results.items()}


__all__ = ["neighbor_apply", "min_image", "PairGeometry", "split_vec", "merge_vec",
           "PAIR_SLOTS_PER_CHUNK", "CPU_PAIR_SLOTS_PER_CHUNK"]
