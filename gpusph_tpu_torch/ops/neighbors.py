"""Cell-grid neighbor infrastructure.

Counterpart of the JAX package's ``ops/neighbors.py``: the reference's first
neighbor-list stages — cell hash (`calcHashDevice`
`buildneibs_kernel.cu:664`), sort by hash (`buildneibs.cu:403`), reorder and
cell-start detection (`buildneibs_kernel.cu:840`).  After the sort a cell's
particles are the contiguous slice ``[cell_start[c], cell_start[c+1])``; the
forces kernel's block plan (`ops/block_plan.py`) is built on these tables.

The sort is ``torch.argsort(stable=True)`` and the cell starts come from
``torch.searchsorted``, so order, hashes and cell starts equal the JAX
package's exactly on the same input.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..defs import Periodicity
from ..state import ParticleState, is_active


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static cell-grid geometry (reference `GlobalData` grid fields,
    `src/GlobalData.h:95-657`, `ProblemCore::set_grid_params`).

    ``order`` is the linearization axis order, fastest axis first (reference
    `src/linearization.h:29-35`).  The forces kernel requires the fastest
    axis to be non-periodic, so that 3-cell neighbor runs are contiguous
    slices of the sorted particle arrays; ``make_grid`` picks such an order.
    """

    origin: Tuple[float, float, float]
    ncells: Tuple[int, int, int]
    cell_size: Tuple[float, float, float]
    periodic: Periodicity = Periodicity.NONE
    order: Tuple[int, int, int] = (0, 1, 2)  # fastest axis first

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.ncells
        return nx * ny * nz

    @property
    def world_size(self) -> Tuple[float, float, float]:
        return tuple(n * s for n, s in zip(self.ncells, self.cell_size))

    @property
    def trash_cell(self) -> int:
        """One-past-the-end cell collecting dead/out-of-domain particles."""
        return self.n_cells

    @property
    def fast_axis_periodic(self) -> bool:
        return bool(self.periodic & (1 << self.order[0]))


def make_grid(
    world_origin: Tuple[float, float, float],
    world_size: Tuple[float, float, float],
    influenceradius: float,
    periodic: Periodicity = Periodicity.NONE,
) -> CellGrid:
    """Size the grid so each cell is at least one influence radius wide
    (reference `ProblemCore::set_grid_params`)."""
    ncells = tuple(max(1, int(ws / influenceradius)) for ws in world_size)
    cell_size = tuple(ws / nc for ws, nc in zip(world_size, ncells))
    fast = 0
    for a in range(3):
        if not (periodic & (1 << a)):
            fast = a
            break
    order = (fast,) + tuple(a for a in range(3) if a != fast)
    return CellGrid(tuple(world_origin), ncells, cell_size, periodic, order)


def cell_coords(grid: CellGrid, pos: torch.Tensor) -> torch.Tensor:
    """Integer cell coordinates (i32[N,3]) of positions, clipped into the
    grid (reference `calcGridPosFromPos`, `src/cuda/cellgrid.cuh`)."""
    f32 = dict(dtype=torch.float32, device=pos.device)
    rel = (pos - torch.tensor(grid.origin, **f32)) / torch.tensor(
        grid.cell_size, **f32)
    ijk = torch.floor(rel).to(torch.int32)
    hi = torch.tensor(grid.ncells, dtype=torch.int32, device=pos.device) - 1
    return torch.minimum(torch.clamp(ijk, min=0), hi)


def linearize(grid: CellGrid, ijk: torch.Tensor) -> torch.Tensor:
    """Axis-ordered linearization (reference `src/linearization.h`)."""
    a0, a1, a2 = grid.order
    n0, n1 = grid.ncells[a0], grid.ncells[a1]
    return (ijk[..., a2] * n1 + ijk[..., a1]) * n0 + ijk[..., a0]


def delinearize(grid: CellGrid, cells: torch.Tensor):
    """Inverse of :func:`linearize`: linear id -> [i, j, k] per world axis."""
    a0, a1, a2 = grid.order
    n0, n1 = grid.ncells[a0], grid.ncells[a1]
    coords = [None, None, None]
    coords[a0] = cells % n0
    coords[a1] = (cells // n0) % n1
    coords[a2] = cells // (n0 * n1)
    return coords


# the 27 neighbor-cell offsets, x fastest (the order of the JAX package)
_OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def neighbor_cell_ids(grid: CellGrid, cells: torch.Tensor) -> torch.Tensor:
    """The 27 neighboring linear cell ids [C,27] of linear ids ``cells`` [C]:
    periodic axes wrap, cells outside a closed axis become the trash cell."""
    coords = delinearize(grid, cells)
    offs = torch.tensor(_OFFSETS, dtype=cells.dtype, device=cells.device)
    valid = torch.ones((cells.shape[0], 27), dtype=torch.bool, device=cells.device)
    wrapped = []
    for axis in range(3):
        n = grid.ncells[axis]
        coord = coords[axis][:, None] + offs[None, :, axis]
        if grid.periodic & (1 << axis):
            wrapped.append(coord % n)
        else:
            valid = valid & (coord >= 0) & (coord < n)
            wrapped.append(coord.clamp(0, n - 1))
    lin = linearize(grid, torch.stack(wrapped, dim=-1))
    return torch.where(valid, lin, grid.trash_cell)


def cell_hash(grid: CellGrid, pos: torch.Tensor, active: torch.Tensor):
    """Linear cell id per particle (i32); inactive slots go to the trash
    cell so they sort to the end and never appear in any neighbor bin."""
    lin = linearize(grid, cell_coords(grid, pos))
    return torch.where(active, lin, grid.trash_cell).to(torch.int32)


@dataclasses.dataclass
class CellAux:
    """Per-rebuild neighbor tables (the reference's CELLSTART/CELLEND
    buffers + sorted order, `src/define_buffers.h`)."""

    cell_start: torch.Tensor  # i32[n_cells+2]: slice starts per cell (+trash,+end)
    cell_count: torch.Tensor  # i32[n_cells+1]
    hash_sorted: torch.Tensor  # i32[N] cell id per (sorted) particle
    max_occupancy: torch.Tensor  # i32[] max particles in any real cell
    n_active: torch.Tensor  # i32[] number of active particles


def build_cells(grid: CellGrid, state: ParticleState) -> Tuple[ParticleState, CellAux]:
    """Sort the particle state by cell hash and build the cell tables.

    Returns the *reordered* state (the reference's REORDER rewrites all
    buffers in sorted order) and the cell tables.
    """
    active = is_active(state.info)
    h = cell_hash(grid, state.pos, active)
    order = torch.argsort(h, stable=True)
    h_sorted = h[order]
    sorted_state = state.map(lambda a: a[order])

    n_cells = grid.n_cells
    cell_ids = torch.arange(n_cells + 2, dtype=torch.int32, device=h.device)
    cell_start = torch.searchsorted(h_sorted, cell_ids).to(torch.int32)
    cell_count = cell_start[1:] - cell_start[:-1]
    max_occ = cell_count[:n_cells].max()
    n_active = active.sum(dtype=torch.int32)
    return sorted_state, CellAux(
        cell_start=cell_start,
        cell_count=cell_count,
        hash_sorted=h_sorted,
        max_occupancy=max_occ,
        n_active=n_active,
    )


__all__ = [
    "CellGrid",
    "CellAux",
    "make_grid",
    "cell_coords",
    "cell_hash",
    "delinearize",
    "neighbor_cell_ids",
    "linearize",
    "build_cells",
]
