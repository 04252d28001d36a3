"""HotFile binary checkpoints: save/resume.

Counterpart of the JAX package's ``io/hotfile.py`` and of the reference's
HotWriter/HotFile (`src/writers/HotFile.h:45-75`, `HotFile.cc:92-177`): a
versioned header {version, buffer_count, particle_count, body_count,
numOpenBoundaries, iterations, t, dt} followed by every per-particle
buffer, with rotating retention.  The encoding is npz (buffers keyed by
name, the header and the body state as JSON strings).

The file is the JAX package's, byte layout and types alike: ``info`` and
``id`` are stored as uint32 (the JAX state's type), and the port's int32
words holding the same bits are converted on save and on load.  Each
package reads the other's checkpoints.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Mapping, Optional, Tuple, Union

import numpy as np

from ..convert import state_from_numpy, state_to_numpy
from ..state import ParticleState

HOT_VERSION = 1


def save_hotfile(
    path: str,
    state: Union[ParticleState, Mapping],
    *,
    t: float,
    dt: float,
    iterations: int,
    body_count: int = 0,
    num_open_boundaries: int = 0,
    body_state: Optional[dict] = None,
) -> None:
    """Write a checkpoint of ``state``: a ParticleState on any device, or
    its host copy in the layout of ``convert.state_to_numpy``."""
    host = state_to_numpy(state) if isinstance(state, ParticleState) else state
    buffers = {k: np.asarray(host[k]) for k in ("pos", "vel", "rho", "mass")}
    for k in ("info", "id"):
        buffers[k] = np.asarray(host[k]).view(np.uint32)
    for k, v in host["extras"].items():
        buffers[f"extra.{k}"] = np.asarray(v)
    header = dict(
        version=HOT_VERSION,
        buffer_count=len(buffers),
        particle_count=int(len(buffers["pos"])),
        body_count=body_count,
        numOpenBoundaries=num_open_boundaries,
        iterations=int(iterations),
        t=float(t),
        dt=float(dt),
    )
    np.savez(
        path,
        __header__=json.dumps(header),
        __bodies__=json.dumps(body_state or {}),
        **buffers,
    )


def load_hotfile(path: str) -> Tuple[ParticleState, dict, dict]:
    """Returns (state on the CPU, header, body_state)."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["__header__"]))
        if header["version"] != HOT_VERSION:
            raise ValueError(f"unsupported hotfile version {header['version']}")
        bodies = json.loads(str(z["__bodies__"]))
        arrays = {k: z[k] for k in ("pos", "vel", "rho", "mass", "info", "id")}
        arrays["extras"] = {k[len("extra."):]: z[k] for k in z.files
                            if k.startswith("extra.")}
    return state_from_numpy(arrays), header, bodies


class HotWriter:
    """Rotating checkpoint writer (reference `HotWriter`, `--checkpoints N`)."""

    def __init__(self, outdir: str, keep: int = 3, prefix: str = "hot"):
        self.outdir = outdir
        self.keep = keep
        self.prefix = prefix
        os.makedirs(outdir, exist_ok=True)
        self._index = 0

    def write(self, state, *, t, dt, iterations, **kw) -> str:
        path = os.path.join(
            self.outdir, f"{self.prefix}_{self._index:05d}.npz"
        )
        save_hotfile(path, state, t=t, dt=dt, iterations=iterations, **kw)
        self._index += 1
        self._rotate()
        return path

    def _rotate(self):
        files = sorted(glob.glob(os.path.join(self.outdir, f"{self.prefix}_*.npz")))
        for f in files[: -self.keep]:
            os.remove(f)


__all__ = ["save_hotfile", "load_hotfile", "HotWriter", "HOT_VERSION"]
