"""Port vs JAX package: the DEM terrain, the STL and XYZ readers and the
INI-driven Generic problem.

The terrain's height and normal and its force on a seeded height field
(points past the east and north edges included, where the interpolation
clamps), the GRASS ASCII round trip, binary and ASCII STL files, their
surface fill and inside test, an XYZ file, and a Generic scene with an STL
obstacle read from an INI file, built by both packages.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu.geometry import stl as jstl
from gpusph_tpu.ops import dem as jdem
from gpusph_tpu.problems.base import GeometryType as JGeometryType
from gpusph_tpu.problems.base import get_problem as jget_problem

from gpusph_tpu_torch.convert import state_to_numpy
from gpusph_tpu_torch.geometry import stl
from gpusph_tpu_torch.ops import dem
from gpusph_tpu_torch.problems.base import GeometryType, get_problem
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)


def seeded_terrain(rows=30, cols=40):
    """A rough seeded height field on 0.1 m cells, and the same descriptor
    packed by both packages."""
    rng = np.random.default_rng(5)
    h = (0.3 + 0.2 * np.sin(np.arange(cols) * 0.3)[None, :]
         + 0.05 * rng.standard_normal((rows, cols))).astype(np.float32)
    packed = dem.pack_dem(h, 0.05, -0.1, 0.1, 0.1)
    assert packed == jdem.pack_dem(h, 0.05, -0.1, 0.1, 0.1)
    return packed


def terrain_points(n=500):
    """Seeded points over the terrain and past each of its edges."""
    rng = np.random.default_rng(6)
    pos = np.stack([rng.uniform(-0.3, 4.3, n), rng.uniform(-0.4, 3.2, n),
                    rng.uniform(0.0, 0.8, n)], axis=1).astype(np.float32)
    return pos


def test_dem_height_normal_matches():
    """Height and unit normal, bilinear with the clamp at cols - 1.001 and
    rows - 1.001 (rtol 1e-6, atol 1e-6: the same f32 formulas)."""
    packed = seeded_terrain()
    pos = terrain_points()
    jz, jn = jdem.dem_height_normal(packed, jnp.asarray(pos))
    z, n = dem.dem_height_normal(packed, torch.as_tensor(pos))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-6)
    # the heights go to a device once per descriptor and device
    assert dem.dem_heights(packed, z.device) is dem.dem_heights(packed, z.device)


def test_apply_dem_force_matches():
    """The LJ repulsion and wall friction of DEMExample's framework over the
    seeded terrain, on fluid and boundary rows (rtol 1e-5, atol 1e-5 of
    the largest term: f32 powers of r0/dist up to 12)."""
    import dataclasses

    packed = seeded_terrain()
    jp = jget_problem("DEMExample")({"deltap": 0.15})
    tp = get_problem("DEMExample")({"deltap": 0.15})
    jp.build()
    tp.build()
    jfw = dataclasses.replace(jp.fw.finalize(), dem=packed)
    tfw = dataclasses.replace(tp.fw.finalize(), dem=packed)
    pos = terrain_points()
    rng = np.random.default_rng(8)
    vel = rng.normal(0.0, 0.5, pos.shape).astype(np.float32)
    mass = np.full(len(pos), 1000.0 * 0.15 ** 3, np.float32)
    fluid = rng.uniform(size=len(pos)) < 0.8
    dvdt = rng.normal(0.0, 1.0, pos.shape).astype(np.float32)
    want = np.asarray(jdem.apply_dem_force(jfw, jnp.asarray(pos), jnp.asarray(vel),
                                           jnp.asarray(mass), jnp.asarray(fluid),
                                           jnp.asarray(dvdt)))
    got = dem.apply_dem_force(tfw, torch.as_tensor(pos), torch.as_tensor(vel),
                              torch.as_tensor(mass), torch.as_tensor(fluid),
                              torch.as_tensor(dvdt)).numpy()
    assert np.abs(want - dvdt).max() > 1.0  # the terrain pushes some particles
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_load_dem_ascii_roundtrip(tmp_path):
    """A GRASS ASCII file (first row north) loads to the same descriptor in
    both packages, and its heights back to the file's rows."""
    rows, cols = 6, 9
    h = np.random.default_rng(9).uniform(0.0, 2.0, (rows, cols)).round(4)
    path = tmp_path / "dem.txt"
    with open(path, "w") as f:
        f.write(f"north: 3.0\nsouth: 0.0\neast: 4.5\nwest: 0.0\nrows: {rows}\ncols: {cols}\n")
        for r in range(rows):
            f.write(" ".join(str(v) for v in h[r]) + "\n")
    packed = dem.load_dem_ascii(str(path))
    assert packed == jdem.load_dem_ascii(str(path))
    hh, west, south, ew, ns = dem.unpack_dem(packed)
    np.testing.assert_array_equal(hh[::-1], h.astype(np.float32))
    assert (west, south, ew, ns) == (0.25, 0.25, 0.5, 0.5)


def cube_tris(lo=0.0, hi=1.0):
    """The 12 triangles of an axis-aligned cube."""
    f = []
    for axis in range(3):
        for side in (lo, hi):
            a1, a2 = (axis + 1) % 3, (axis + 2) % 3
            c = np.full(3, lo)
            c[axis] = side
            p = [c.copy() for _ in range(4)]
            p[1][a1] = hi
            p[2][a1] = hi
            p[2][a2] = hi
            p[3][a2] = hi
            f.append([p[0], p[1], p[2]])
            f.append([p[0], p[2], p[3]])
    return np.asarray(f)


def write_stl(path, tris, binary=True):
    if binary:
        with open(path, "wb") as fp:
            fp.write(b"solid-looking header".ljust(80, b"\0"))
            fp.write(struct.pack("<I", len(tris)))
            for t in tris:
                fp.write(struct.pack("<3f", 0, 0, 0))
                for v in t:
                    fp.write(struct.pack("<3f", *v))
                fp.write(struct.pack("<H", 0))
    else:
        with open(path, "w") as f:
            f.write("solid t\n")
            for t in tris:
                f.write(" facet normal 0 0 0\n  outer loop\n")
                for v in t:
                    f.write(f"   vertex {v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
                f.write("  endloop\n endfacet\n")
            f.write("endsolid t\n")


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_stl_load_fill_inside(tmp_path, binary):
    """An STL cube (binary, with a header that starts with 'solid', or
    ASCII) loads to the same triangles, surface points and inside test as
    the JAX package's, exactly."""
    tris = cube_tris(0.1, 0.3)
    path = str(tmp_path / "cube.stl")
    write_stl(path, tris, binary)
    got = stl.load_stl(path)
    want = jstl.load_stl(path)
    assert got.shape == (12, 3, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, tris, atol=1e-7)
    pts = stl.fill_stl_surface(got, 0.02)
    np.testing.assert_array_equal(pts, jstl.fill_stl_surface(want, 0.02))
    on_face = np.zeros(len(pts), bool)
    for a in range(3):
        on_face |= np.isclose(pts[:, a], 0.1, atol=1e-6) | np.isclose(pts[:, a], 0.3, atol=1e-6)
    assert len(pts) > 500 and on_face.all()
    probe = np.random.default_rng(3).uniform(0.0, 0.4, (300, 3))
    inside = stl.stl_inside_predicate(got)(probe)
    np.testing.assert_array_equal(inside, jstl.stl_inside_predicate(want)(probe))
    np.testing.assert_array_equal(inside, np.all((probe > 0.1) & (probe < 0.3), axis=1))


def test_add_xyz_file(tmp_path):
    """Points of a seeded XYZ file (extra columns ignored) as a fluid
    geometry, in both packages."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(0.1, 0.5, (200, 3))
    path = tmp_path / "pts.xyz"
    np.savetxt(path, np.concatenate([pts, rng.uniform(size=(200, 1))], axis=1))
    jp = jget_problem("DamBreak3D")({"deltap": 0.1})
    tp = get_problem("DamBreak3D")({"deltap": 0.1})
    jg = jp.add_xyz_file(JGeometryType.FLUID, str(path))
    tg = tp.add_xyz_file(GeometryType.FLUID, str(path))
    np.testing.assert_array_equal(tp.geometries[tg].points, jp.geometries[jg].points)
    np.testing.assert_allclose(tp.geometries[tg].points, pts, rtol=1e-15)
    assert tp.get_dynamic_boundaries_layers() == jp.get_dynamic_boundaries_layers() == 3


GENERIC_INI = """
[problem]
name = MiniDamSTL
deltap = 0.05
tend = 0.5
boundary = DYN_BOUNDARY
turbulence = ARTIFICIAL
density_diffusion = COLAGROSSI
gravity = 0 0 -9.81
water_level = 0.3

[domain]
origin = 0 0 0
size = 1.0 0.5 0.5

[fluid0]
rho0 = 1000
gamma = 7
c0 = 20

[geometry0]
type = fixed_boundary
shape = box_border
origin = 0 0 0
size = 1.0 0.5 0.5
open_top = true

[geometry1]
type = fluid
shape = box
origin = 0.15 0.15 0.15
size = 0.3 0.2 0.15

[geometry2]
type = fixed_boundary
shape = stl
path = {stl}

[geometry3]
type = fixed_boundary
shape = cylinder
center = 0.8 0.1 0.15
radius = 0.05
height = 0.1

[geometry4]
type = fixed_boundary
shape = sphere
center = 0.8 0.35 0.25
radius = 0.06
fill = border

[geometry5]
type = testpoint
origin = 0.8 0.25 0.05
"""


def test_generic_build_matches(tmp_path):
    """Generic from an INI file with every shape of the schema (an STL
    obstacle among them): the grid, the state and the framework exactly as
    the JAX package builds them."""
    path = tmp_path / "obstacle.stl"
    write_stl(str(path), cube_tris(0.0, 0.1) + np.array([0.6, 0.2, 0.15]))
    ini = tmp_path / "mini.ini"
    ini.write_text(GENERIC_INI.format(stl=path))
    jp = jget_problem("Generic")({"config": str(ini)})
    tp = get_problem("Generic")({"config": str(ini)})
    jgrid, jst = jp.build()
    tgrid, tst = tp.build()
    assert tp.name == jp.name == "MiniDamSTL"
    for f in ("origin", "ncells", "cell_size", "periodic", "order"):
        assert getattr(tgrid, f) == getattr(jgrid, f), f
    got = state_to_numpy(tst)
    for k in ("pos", "vel", "mass", "info", "id", "rho"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jst, k)), err_msg=k)
    assert sorted(got["extras"]) == sorted(jst.extras)
    for f in ("max_blocks", "max_block_groups", "max_parts_per_cell", "densityDiffCoeff",
              "slength", "tend"):
        assert getattr(tp.fw.sp, f) == getattr(jp.fw.sp, f), f
    assert tp.testpoints == jp.testpoints
    assert int(tst.count_active()) > 1000
    stl_geom = tp.geometries[2]
    assert stl_geom.mesh_tris.shape == (12, 3, 3) and len(stl_geom.points) > 40
    from gpusph_tpu_torch.ops.forces_kernel import kernel_supported

    assert kernel_supported(tp.fw.finalize(), tgrid)


def test_generic_needs_a_config():
    with pytest.raises(ValueError, match="--config"):
        get_problem("Generic")({})


def test_cli_config_and_dem_options(tmp_path, capsys):
    """``--config`` reaches Generic and ``--dem`` reaches DEMExample through
    the CLI (ten iterations each on the CPU: the forces kernel's plain
    version, the terrain's force from the file)."""
    from gpusph_tpu_torch import cli

    path = tmp_path / "obstacle.stl"
    write_stl(str(path), cube_tris(0.0, 0.1) + np.array([0.6, 0.2, 0.15]))
    ini = tmp_path / "mini.ini"
    ini.write_text(GENERIC_INI.format(stl=path))
    assert cli.main(["Generic", "--config", str(ini), "--maxiter", "10", "--device", "cpu",
                     "--dir", str(tmp_path / "g")]) == 0
    assert "Problem MiniDamSTL:" in capsys.readouterr().out
    dem_file = tmp_path / "hill.txt"
    rows, cols = 12, 30
    x = (np.arange(cols) + 0.5) * 0.2
    h = np.tile(0.05 + 0.3 * np.clip((x - 2.0) / 3.0, 0.0, 1.0), (rows, 1))
    with open(dem_file, "w") as f:
        f.write(f"north: 2.4\nsouth: 0.0\neast: 6.0\nwest: 0.0\nrows: {rows}\ncols: {cols}\n")
        for r in range(rows):
            f.write(" ".join(f"{v:.4f}" for v in h[r]) + "\n")
    assert cli.main(["DEMExample", "--dem", str(dem_file), "--deltap", "0.15",
                     "--water_height", "0.4", "--maxiter", "10", "--device", "cpu",
                     "--dir", str(tmp_path / "d")]) == 0
    assert get_problem("DEMExample")({"dem": str(dem_file)}).fw.dem == \
        dem.load_dem_ascii(str(dem_file))
