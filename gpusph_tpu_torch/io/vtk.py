"""VTK XML (VTU) and legacy VTK particle writers, and their readers.

Counterpart of the JAX package's ``io/vtk.py`` and of the reference's VTKWriter
(`src/writers/VTKWriter.{h,cc}`): writes one ``PVTP``-free ``.vtu`` per save
with Pressure/Velocity/Density/Mass/Info fields (appended raw binary, like
the reference's appended-data encoder) and maintains a ``.pvd`` time-series
index (reference `VTKWriter::add_timefile`).  Output is readable by ParaView
and by `scripts/vtkdiff.py`-style tooling.

The writers take host numpy arrays (the dispatcher copies the state to the
host once per write, `io/writers.py`) and encode them with numpy: appended
raw binary for VTU, ASCII for the legacy format.  The files are the JAX
package's: each package reads the other's.
"""
from __future__ import annotations

import os
import re
import struct
import xml.sax.saxutils as sx
from typing import Dict

import numpy as np


class VTKWriter:
    def __init__(self, outdir: str, prefix: str = "PART"):
        self.outdir = outdir
        self.prefix = prefix
        os.makedirs(outdir, exist_ok=True)
        self._series = []  # (time, filename)
        self._index = 0

    def write(self, time: float, arrays: Dict[str, np.ndarray]) -> str:
        """Write one snapshot.  ``arrays`` must hold 'pos' [n,3]; any other
        entries become point-data fields ([n] scalar or [n,k] vector)."""
        pos = np.ascontiguousarray(arrays["pos"], np.float32)
        n = len(pos)
        fname = f"{self.prefix}_{self._index:05d}.vtu"
        path = os.path.join(self.outdir, fname)

        fields = {k: v for k, v in arrays.items() if k != "pos"}

        # appended raw-binary encoding: offsets into the data block
        blobs = []
        offset = 0

        def add_blob(a: np.ndarray) -> int:
            nonlocal offset
            raw = np.ascontiguousarray(a).tobytes()
            blobs.append(struct.pack("<I", len(raw)) + raw)
            off = offset
            offset += 4 + len(raw)
            return off

        def vtk_type(a: np.ndarray) -> str:
            return {
                np.dtype(np.float32): "Float32",
                np.dtype(np.float64): "Float64",
                np.dtype(np.int32): "Int32",
                np.dtype(np.uint32): "UInt32",
                np.dtype(np.uint8): "UInt8",
                np.dtype(np.int64): "Int64",
            }[a.dtype]

        lines = []
        w = lines.append
        w('<?xml version="1.0"?>')
        w('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">')
        w(" <UnstructuredGrid>")
        w(f'  <Piece NumberOfPoints="{n}" NumberOfCells="{n}">')

        w("   <PointData>")
        data_entries = []
        for name, a in fields.items():
            a = np.ascontiguousarray(a)
            ncomp = 1 if a.ndim == 1 else a.shape[1]
            off = add_blob(a)
            w(
                f'    <DataArray Name="{sx.escape(name)}" type="{vtk_type(a)}"'
                f' NumberOfComponents="{ncomp}" format="appended" offset="{off}"/>'
            )
        w("   </PointData>")

        w("   <Points>")
        off = add_blob(pos)
        w(
            f'    <DataArray type="Float32" NumberOfComponents="3"'
            f' format="appended" offset="{off}"/>'
        )
        w("   </Points>")

        # cells: one VTK_VERTEX per particle
        w("   <Cells>")
        conn = np.arange(n, dtype=np.int32)
        off = add_blob(conn)
        w(
            f'    <DataArray Name="connectivity" type="Int32" format="appended" offset="{off}"/>'
        )
        offs = np.arange(1, n + 1, dtype=np.int32)
        off = add_blob(offs)
        w(
            f'    <DataArray Name="offsets" type="Int32" format="appended" offset="{off}"/>'
        )
        types = np.full(n, 1, np.uint8)  # VTK_VERTEX
        off = add_blob(types)
        w(
            f'    <DataArray Name="types" type="UInt8" format="appended" offset="{off}"/>'
        )
        w("   </Cells>")
        w("  </Piece>")
        w(" </UnstructuredGrid>")
        w(' <AppendedData encoding="raw">')

        with open(path, "wb") as f:
            f.write("\n".join(lines).encode())
            f.write(b"\n  _")
            for b in blobs:
                f.write(b)
            f.write(b"\n </AppendedData>\n</VTKFile>\n")

        self._series.append((time, fname))
        self._index += 1
        self._write_pvd()
        return path

    def _write_pvd(self):
        """Time-series index (reference `VTKWriter` .pvd handling)."""
        path = os.path.join(self.outdir, f"{self.prefix}.pvd")
        with open(path, "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write(
                '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">\n'
            )
            f.write(" <Collection>\n")
            for t, fn in self._series:
                f.write(
                    f'  <DataSet timestep="{t}" group="" part="0" file="{fn}"/>\n'
                )
            f.write(" </Collection>\n</VTKFile>\n")


def read_vtu(path: str) -> Dict[str, np.ndarray]:
    """Minimal VTU reader for our own appended-raw files (the analogue of the
    reference's `VTUReader`, used by tests and vtkdiff tooling)."""
    with open(path, "rb") as f:
        data = f.read()
    header, _, appended = data.partition(b'<AppendedData encoding="raw">')
    appended = appended.split(b"_", 1)[1]

    out = {}
    entries = re.findall(rb"<DataArray[^>]*/>", header)
    for e in entries:
        def attr(name, default=None):
            m = re.search(name.encode() + rb'="([^"]*)"', e)
            return m.group(1).decode() if m else default

        name = attr("Name", "")
        typ = attr("type")
        ncomp = int(attr("NumberOfComponents", "1"))
        off = int(attr("offset"))
        dtype = {
            "Float32": np.float32,
            "Float64": np.float64,
            "Int32": np.int32,
            "UInt32": np.uint32,
            "UInt8": np.uint8,
            "Int64": np.int64,
        }[typ]
        (size,) = struct.unpack_from("<I", appended, off)
        a = np.frombuffer(appended, dtype=dtype, count=size // np.dtype(dtype).itemsize, offset=off + 4)
        if ncomp > 1:
            a = a.reshape(-1, ncomp)
        key = name if name else "pos"
        if key in ("connectivity", "offsets", "types"):
            continue
        out[key] = a
    return out


class VTKLegacyWriter:
    """ASCII legacy-VTK (.vtk POLYDATA) particle writer — the reference's
    VTKLegacyWriter (`src/writers/VTKLegacyWriter.cc:64-190`): POINTS +
    1-vertex cells, then Velocity/Pressure/Density/Mass point data plus
    Type+flags/ParticleId int scalars and optional Vorticity, with a
    ``VTUinp.pvd`` collection index alongside."""

    def __init__(self, outdir: str, prefix: str = "PART", *,
                 multifluid: bool = False, has_objects: bool = False):
        self.outdir = outdir
        self.prefix = prefix
        # VTKLegacyWriter.cc emits the Fluid scalar only for multifluid
        # runs, and Object instead when bodies exist
        self.multifluid = multifluid
        self.has_objects = has_objects
        os.makedirs(outdir, exist_ok=True)
        self._series = []
        self._index = 0

    def write(self, time: float, arrays: Dict[str, np.ndarray]) -> str:
        pos = np.asarray(arrays["pos"], np.float64)
        n = len(pos)
        fname = f"{self.prefix}_{self._index:05d}.vtk"
        path = os.path.join(self.outdir, fname)
        with open(path, "w") as f:
            f.write("# vtk DataFile Version 2.0\n")
            f.write(f"{self.prefix} t={time:.9g}\n")
            f.write("ASCII\nDATASET POLYDATA\n")
            f.write(f"POINTS {n} double\n")
            np.savetxt(f, pos, fmt="%.9g")
            f.write(f"\nVERTICES {n} {2 * n}\n")
            np.savetxt(
                f,
                np.stack([np.ones(n, np.int64), np.arange(n)], axis=1),
                fmt="%d",
            )
            f.write(f"\nPOINT_DATA {n}\n")

            def scalars(name, a, typ="float", fmt="%.9g"):
                f.write(f"SCALARS {name} {typ}\nLOOKUP_TABLE default\n")
                np.savetxt(f, np.asarray(a).reshape(-1, 1), fmt=fmt)
                f.write("\n")

            def vectors(name, a):
                f.write(f"VECTORS {name} float\n")
                np.savetxt(f, np.asarray(a), fmt="%.9g")
                f.write("\n")

            if "Velocity" in arrays:
                vectors("Velocity", arrays["Velocity"])
            for k in ("Pressure", "Density", "Mass"):
                if k in arrays:
                    scalars(k, arrays[k])
            if "Vorticity" in arrays:
                vectors("Vorticity", arrays["Vorticity"])
            if "Info" in arrays:
                info = np.asarray(arrays["Info"], np.uint32)
                scalars("Type+flags", info & 0xFFFF, "int", "%d")
                if self.multifluid:
                    scalars("Fluid", (info >> 16) & 0xFF, "int", "%d")
                elif self.has_objects:
                    scalars("Object", (info >> 16) & 0xFF, "int", "%d")
            if "Id" in arrays:
                scalars("ParticleId", arrays["Id"], "int", "%d")
        self._series.append((time, fname))
        self._index += 1
        self._write_pvd()
        return path

    def _write_pvd(self):
        path = os.path.join(self.outdir, "VTUinp.pvd")
        with open(path, "w") as f:
            f.write("<?xml version='1.0'?>\n")
            f.write("<VTKFile type='Collection' version='0.1'>\n <Collection>\n")
            for t, fn in self._series:
                f.write(
                    f"  <DataSet timestep='{t:.9g}' group='' part='0' "
                    f"file='{sx.escape(fn)}'/>\n"
                )
            f.write(" </Collection>\n</VTKFile>\n")


def read_vtk_legacy(path: str) -> Dict[str, np.ndarray]:
    """Parse an ASCII legacy .vtk POLYDATA particle file (tests/tools)."""
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0
    n = 0
    while i < len(lines):
        ln = lines[i].split()
        if not ln:
            i += 1
            continue
        if ln[0] == "POINTS":
            n = int(ln[1])
            out["pos"] = np.loadtxt(lines[i + 1:i + 1 + n]).reshape(n, 3)
            i += n + 1
        elif ln[0] == "VECTORS":
            out[ln[1]] = np.loadtxt(lines[i + 1:i + 1 + n]).reshape(n, 3)
            i += n + 1
        elif ln[0] == "SCALARS":
            out[ln[1]] = np.loadtxt(lines[i + 2:i + 2 + n]).reshape(n)
            i += n + 2
        else:
            i += 1
    return out


__all__ = ["VTKWriter", "VTKLegacyWriter", "read_vtu", "read_vtk_legacy"]
