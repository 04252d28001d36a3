"""Writer dispatcher, text writer and the CommonWriter scalar series.

Counterpart of the JAX package's ``io/writers.py``, of the reference's
Writer registry (`src/Writer.h:139-220`), its CommonWriter scalar time
series (`src/writers/CommonWriter.cc:53-170`: energy.txt, WaveGage.txt,
rbdata.txt / objectforces.txt, IOflux.txt) and its plain-text particle
dumps (`src/writers/TextWriter.cc`).

The state stays on its device between writes.  A write runs the
post-process pass and the equation of state there, then copies what the
writers need to the host in one transfer (:func:`host_snapshot`); every
writer works on those host numpy arrays.  The files are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Dict, Optional

import numpy as np
import torch

from ..bodies import BODY_FIELDS, BodiesState, bodies_to_dict
from ..defs import ParticleType, PostProcessType
from ..framework import SimFramework
from ..ops import eos
from ..state import FG_INACTIVE, FG_SURFACE, ParticleState, fluid_num
from .hotfile import HotWriter
from .vtk import VTKLegacyWriter, VTKWriter

_HOST_VIEW = {torch.float32: np.float32, torch.int32: np.int32}


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy 32-bit tensors to the host in one transfer: their words are
    packed into one buffer on their device, copied, and split again."""
    flat = torch.cat([t.reshape(-1).view(torch.int32) for t in tensors.values()])
    words = flat.cpu().numpy()
    out, o = {}, 0
    for k, t in tensors.items():
        n = t.numel()
        out[k] = words[o:o + n].view(_HOST_VIEW[t.dtype]).reshape(tuple(t.shape))
        o += n
    return out


@dataclasses.dataclass
class HostSnapshot:
    """What one write needs, on the host.  ``state`` has the layout of
    ``convert.state_to_numpy`` (info and id as uint32); ``press`` and
    ``rho_phys`` are present when a particle writer is due."""

    state: dict
    press: Optional[np.ndarray] = None
    rho_phys: Optional[np.ndarray] = None
    post: Optional[dict] = None
    bodies: Optional[dict] = None

    @property
    def active(self) -> np.ndarray:
        info = self.state["info"]
        return ((info & 7) != ParticleType.NONE) & ((info & FG_INACTIVE) == 0)

    @property
    def fluid(self) -> np.ndarray:
        return ((self.state["info"] & 7) == ParticleType.FLUID) & self.active


def host_snapshot(fw: SimFramework, state: ParticleState, post=None,
                  bodies: Optional[BodiesState] = None, *,
                  particle_fields: bool = True) -> HostSnapshot:
    """Pressure and physical density on the state's device (when
    ``particle_fields``), then one copy of the state, those fields, the
    post-process outputs and the bodies to the host."""
    t = {k: getattr(state, k) for k in ("pos", "vel", "rho", "mass", "info", "id")}
    t.update({f"extra.{k}": v for k, v in state.extras.items()})
    if particle_fields:
        f_num = fluid_num(state.info)
        t["press"] = eos.pressure(fw.pp, state.rho, f_num)
        t["rho_phys"] = eos.physical_density(fw.pp, state.rho, f_num)
    t.update({f"post.{k}": v for k, v in (post or {}).items()})
    if bodies is not None:
        t.update({f"body.{k}": getattr(bodies, k) for k in BODY_FIELDS})
    h = to_host(t)
    st = {k: h[k] for k in ("pos", "vel", "rho", "mass")}
    st.update(info=h["info"].view(np.uint32), id=h["id"].view(np.uint32))
    st["extras"] = {k: h[f"extra.{k}"] for k in state.extras}

    def prefixed(p):
        return {k[len(p):]: v for k, v in h.items() if k.startswith(p)}

    return HostSnapshot(
        state=st, press=h.get("press"), rho_phys=h.get("rho_phys"),
        post=prefixed("post.") if post else None,
        bodies=prefixed("body.") if bodies is not None else None)


def state_arrays(snap: HostSnapshot) -> Dict[str, np.ndarray]:
    """The active particles' writable fields, from a host snapshot taken
    with the particle fields and the output of the write-out POSTPROCESS
    pass (:func:`gpusph_tpu_torch.ops.postprocess.make_write_postprocess`):
    its full-capacity arrays are masked to active rows and merged in (Info
    is replaced when surface detection refreshed the FG_SURFACE flags,
    matching the reference's saveParticles POSTPROCESS semantics,
    `src/GPUSPH.cc:1732`)."""
    s, post = snap.state, snap.post
    act = snap.active
    out = {
        "pos": s["pos"][act],
        "Velocity": s["vel"][act],
        "Pressure": snap.press[act],
        "Density": snap.rho_phys[act],
        "Mass": s["mass"][act],
        "Info": s["info"][act],
        "Id": s["id"][act],
    }
    if post:
        for k in ("Vorticity", "Normals"):
            if k in post:
                out[k] = post[k][act]
        if "Info" in post:
            out["Info"] = post["Info"].view(np.uint32)[act]
        if "TestpointVel" in post:
            # testpoint rows carry the interpolated values in the dump too
            tp = (s["info"][act] & 7) == ParticleType.TESTPOINT
            out["Velocity"] = np.where(tp[:, None], post["TestpointVel"][act],
                                       out["Velocity"])
            out["Pressure"] = np.where(tp, post["TestpointPress"][act], out["Pressure"])
    return out


class TextWriter:
    """Plain-text particle dump (reference `src/writers/TextWriter.cc`)."""

    def __init__(self, outdir: str, prefix: str = "PART"):
        self.outdir = outdir
        self.prefix = prefix
        os.makedirs(outdir, exist_ok=True)
        self._index = 0

    def write(self, time: float, arrays: Dict[str, np.ndarray]) -> str:
        path = os.path.join(self.outdir, f"{self.prefix}_{self._index:05d}.txt")
        rows = np.column_stack([
            arrays["pos"], arrays["Velocity"], arrays["Density"],
            arrays["Pressure"], arrays["Info"] & 7]).astype(np.float64)
        np.savetxt(path, rows, fmt=["%.9g"] * 8 + ["%d"],
                   header="x y z vx vy vz rho p type", comments="# ")
        self._index += 1
        return path


class CommonWriter:
    """Always-on scalar time series (reference `CommonWriter.cc:53-170`),
    written from host snapshots."""

    def __init__(self, outdir: str, fw: SimFramework, gages=(), n_bodies: int = 0):
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.fw = fw
        self._write_summary()
        self.gages = list(gages)
        self._energy = open(os.path.join(outdir, "energy.txt"), "w")
        self._energy.write("# time kinetic potential internal\n")
        if self.gages:
            self._gage = open(os.path.join(outdir, "WaveGage.txt"), "w")
            self._gage.write("# time " + " ".join(f"z{i}" for i in range(len(self.gages))) + "\n")
        else:
            self._gage = None
        if n_bodies:
            # body kinematics + fluid forces time series (reference
            # rbdata.txt / objectforces.txt, CommonWriter.cc:120-170)
            self._rb = open(os.path.join(outdir, "rbdata.txt"), "w")
            self._rb.write("# time body cgx cgy cgz vx vy vz wx wy wz\n")
            self._objf = open(os.path.join(outdir, "objectforces.txt"), "w")
            self._objf.write("# time body fx fy fz tx ty tz\n")
        else:
            self._rb = self._objf = None
        # volumetric flux through open boundaries (reference IOflux.txt,
        # CommonWriter.cc) -- written when FLUX_COMPUTATION post-process on
        if PostProcessType.FLUX_COMPUTATION in fw.postprocess:
            self._ioflux = open(os.path.join(outdir, "IOflux.txt"), "w")
            self._ioflux.write("# time inlet_flux outlet_flux\n")
        else:
            self._ioflux = None
        self._tp = None

    def write_ioflux(self, time: float, post):
        if self._ioflux is None or not post or "IOflux" not in post:
            return
        q = np.asarray(post["IOflux"])
        self._ioflux.write(f"{time:.9g} {q[0]:.6e} {q[1]:.6e}\n")
        self._ioflux.flush()

    def write_bodies(self, time: float, bodies: Optional[dict]):
        """``bodies``: host arrays of the body state (a snapshot's)."""
        if self._rb is None or bodies is None:
            return
        cg, lv, av = bodies["cg"], bodies["linvel"], bodies["angvel"]
        f, tq = bodies["force"], bodies["torque"]
        for b in range(1, len(cg)):
            self._rb.write(
                f"{time:.9g} {b} " + " ".join(f"{v:.9g}" for v in (*cg[b], *lv[b], *av[b])) + "\n"
            )
            self._objf.write(
                f"{time:.9g} {b} " + " ".join(f"{v:.9g}" for v in (*f[b], *tq[b])) + "\n"
            )
        self._rb.flush()
        self._objf.flush()

    def _write_summary(self):
        """Dump every framework/simulation/physical option (the reference's
        CommonWriter summary file, `src/writers/CommonWriter.cc`)."""
        fw = self.fw
        with open(os.path.join(self.outdir, "summary.txt"), "w") as f:
            f.write("# gpusph_tpu_torch run summary\n")
            for name in ("kerneltype", "sph_formulation", "boundarytype",
                         "densitydiffusiontype", "periodicbound", "flags"):
                f.write(f"{name} = {getattr(fw, name)!r}\n")
            f.write(f"visc = {fw.visc!r}\n")
            f.write(f"filters = {fw.filters!r}\n")
            f.write(f"postprocess = {fw.postprocess!r}\n")
            for section, obj in (("simparams", fw.sp), ("physparams", fw.pp)):
                f.write(f"[{section}]\n")
                for fld in dataclasses.fields(obj):
                    f.write(f"  {fld.name} = {getattr(obj, fld.name)!r}\n")

    def write_testpoints(self, time: float, snap: HostSnapshot):
        """Interpolated velocity/pressure at TESTPOINT particles
        (calcTestpointsVelocityDevice output; the reference dumps these rows
        in the particle files — here also as a testpoints.txt series)."""
        if self._tp is None:
            self._tp = open(os.path.join(self.outdir, "testpoints.txt"), "w")
            self._tp.write("# time point x y z vx vy vz p\n")
        s = snap.state
        tp = snap.active & ((s["info"] & 7) == ParticleType.TESTPOINT)
        pos = s["pos"]
        vel = snap.post["TestpointVel"]
        press = snap.post["TestpointPress"]
        for k, i in enumerate(np.nonzero(tp)[0]):
            self._tp.write(
                f"{time:.9g} {k} "
                + " ".join(f"{v:.9g}" for v in (*pos[i], *vel[i], press[i]))
                + "\n"
            )
        self._tp.flush()

    def write(self, time: float, snap: HostSnapshot):
        # float64 host reductions: order-stable, more accurate than the
        # reference's Kahan-compensated f32 sums (src/kahan.h)
        s, post = snap.state, snap.post
        fluid = snap.fluid
        m = np.where(fluid, s["mass"].astype(np.float64), 0.0)
        vel = s["vel"].astype(np.float64)
        pos = s["pos"].astype(np.float64)
        ekin = 0.5 * float((m * (vel * vel).sum(axis=1)).sum())
        g = np.asarray(self.fw.pp.gravity, np.float64)
        epot = -float((m * (pos @ g)).sum())
        u = s["extras"].get("energy")
        eint = float((m * u.astype(np.float64)).sum()) if u is not None else 0.0
        self._energy.write(
            f"{time:.9g}\t{float(ekin):.9g}\t{float(epot):.9g}\t{eint:.9g}\n"
        )
        self._energy.flush()

        if self._gage is not None:
            # surface-particle elevation average (GPUSPH.cc:1650-1667):
            # Wendland-2D weighted mean of surface-particle z within 2w of
            # the gage; w=0 -> nearest surface particle's z
            info = post["Info"].view(np.uint32) if post and "Info" in post else s["info"]
            surf = fluid & ((info & FG_SURFACE) != 0)
            pos = s["pos"][surf]
            if not surf.any():
                # no surface flags available (surface detection not run):
                # fall back to the max-z heuristic over fluid particles
                pos = s["pos"][fluid]
            heights = []
            for g in self.gages:
                gx, gy = g[0], g[1]
                w = g[2] if len(g) > 2 else 0.0
                r = np.hypot(pos[:, 0] - gx, pos[:, 1] - gy)
                if not len(pos):
                    heights.append(float("nan"))
                elif not surf.any():
                    near = r < 2 * self.fw.sp.slength
                    heights.append(
                        pos[near, 2].max() if near.any() else float("nan"))
                elif w > 0:
                    q = r / w
                    W = np.where(q < 2.0, (1.0 - 0.5 * q) ** 4 * (2.0 * q + 1.0), 0.0)
                    den = W.sum()
                    # no surface particle within 2w: NaN like the reference's
                    # 0/0 (GPUSPH.cc:1693) so missing data stays visible
                    heights.append(
                        float((W * pos[:, 2]).sum() / den) if den > 0
                        else float("nan"))
                else:
                    heights.append(float(pos[np.argmin(r), 2]))
            self._gage.write(
                f"{time:.9g}\t" + "\t".join(f"{h:.9g}" for h in heights) + "\n"
            )
            self._gage.flush()

    def close(self):
        for f in (self._energy, self._gage, self._rb, self._objf, self._ioflux, self._tp):
            if f is not None:
                f.close()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class WriterDispatcher:
    """Static multi-writer registry with per-writer frequencies
    (reference `Writer::Write/StartWriting/MarkWritten`).

    ``timing`` accumulates the seconds of the writes it made: the
    post-process pass (``post``), the copy to the host (``copy``) and the
    file writes (``files``), over ``writes`` calls of :meth:`maybe_write`."""

    def __init__(self, outdir: str, fw: SimFramework, *, vtk_every=0.0,
                 text_every=0.0, vtklegacy_every=0.0, hot_every=0.0,
                 keep_hot=3, gages=(), n_bodies=0, grid=None):
        from ..ops.postprocess import make_write_postprocess

        self.fw = fw
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        data = os.path.join(outdir, "data")
        self.writers = []
        if vtk_every > 0:
            self.writers.append((VTKWriter(data), vtk_every, [0.0]))
        if vtklegacy_every > 0:
            self.writers.append((
                VTKLegacyWriter(data, multifluid=len(fw.pp.fluids) > 1,
                                has_objects=n_bodies > 0),
                vtklegacy_every, [0.0],
            ))
        if text_every > 0:
            self.writers.append((TextWriter(data), text_every, [0.0]))
        self.common = CommonWriter(outdir, fw, gages=gages, n_bodies=n_bodies)
        self.hot = HotWriter(outdir, keep=keep_hot) if hot_every > 0 else None
        self.hot_every = hot_every
        self._next_hot = hot_every
        # write-out POSTPROCESS pass (saveParticles, src/GPUSPH.cc:1732)
        self._post_fn = (make_write_postprocess(fw, grid)
                         if grid is not None and fw.postprocess else None)
        self.timing = dict(post=0.0, copy=0.0, files=0.0, writes=0)

    def maybe_write(self, time: float, state: ParticleState, *, dt=0.0, iterations=0,
                    force=False, bodies: Optional[BodiesState] = None):
        t0 = _time.perf_counter()
        due_writers = [(w, every, next_t) for w, every, next_t in self.writers
                       if force or time + 1e-12 >= next_t[0]]
        hot_due = self.hot is not None and (force or time + 1e-12 >= self._next_hot)
        # postprocess (surface detection, testpoints) only when a particle
        # writer is due — gages fall back to the max-z heuristic between
        # writer dues instead of paying the pass per callback
        post = None
        if (force or due_writers) and self._post_fn is not None:
            post = self._post_fn(state)
            _sync(state.pos.device)
        t1 = _time.perf_counter()
        snap = host_snapshot(self.fw, state, post, bodies,
                             particle_fields=bool(due_writers))
        t2 = _time.perf_counter()
        if post is not None and "TestpointPress" in post:
            self.common.write_testpoints(time, snap)
        self.common.write_ioflux(time, snap.post)
        if due_writers:
            arrays = state_arrays(snap)
            for writer, every, next_t in due_writers:
                writer.write(time, arrays)
                next_t[0] = time + every
        self.common.write(time, snap)
        self.common.write_bodies(time, snap.bodies)
        if hot_due:
            self.hot.write(snap.state, t=time, dt=dt, iterations=iterations,
                           body_state=bodies_to_dict(snap.bodies))
            self._next_hot = time + self.hot_every
        t3 = _time.perf_counter()
        tm = self.timing
        tm["post"] += t1 - t0
        tm["copy"] += t2 - t1
        tm["files"] += t3 - t2
        tm["writes"] += 1

    def close(self):
        self.common.close()


__all__ = ["TextWriter", "CommonWriter", "WriterDispatcher", "state_arrays",
           "host_snapshot", "HostSnapshot", "to_host"]
