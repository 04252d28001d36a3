"""Port vs JAX package: the output path of DamBreak3D at dp 0.06.

* Writers: both packages' ``WriterDispatcher`` write the same three states
  (the built state with velocities and densities perturbed from a numpy
  seed, and bodies in motion) with the VTU, legacy-VTK and text writers,
  the CommonWriter series and hotfiles on.  The files are read back with
  the JAX package's readers: ``pos``, ``Mass``, ``Id`` and ``Info`` exact,
  ``Velocity`` exact off the test-point rows; ``Pressure`` and ``Density``
  at rtol 1e-6 (each package's f32 equation of state); the test-point rows
  carry each package's post-process interpolation, held at the
  post-process tolerance (rtol 1e-5, atol 1e-6 x max).
* Hotfiles: a checkpoint written by either package loads in the other's
  ``load_hotfile`` with identical arrays, header and body state.
* CLI: ``python -m gpusph_tpu_torch`` on the CPU with checkpoints, then a
  resume from the middle hotfile, must end bit-identical to the straight
  run: the CPU path is deterministic, and a hotfile carries t, dt, the
  iteration count and the bodies exactly (f32 values in JSON doubles).
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest

from gpusph_tpu import bodies as jbodies
from gpusph_tpu.io import hotfile as jhot
from gpusph_tpu.io.vtk import read_vtk_legacy, read_vtu
from gpusph_tpu.io.writers import WriterDispatcher as JDispatcher
from gpusph_tpu.problems.base import get_problem as jget_problem

from gpusph_tpu_torch import bodies as tbodies
from gpusph_tpu_torch import cli
from gpusph_tpu_torch.convert import bodies_from_numpy, state_from_numpy, state_to_numpy
from gpusph_tpu_torch.io import hotfile as thot
from gpusph_tpu_torch.io import vtk as tvtk
from gpusph_tpu_torch.io.writers import WriterDispatcher as TDispatcher
from gpusph_tpu_torch.problems.base import get_problem
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

DELTAP = 0.06
RTOL = 1e-6
POST = dict(rtol=1e-5, atol_frac=1e-6)  # the post-process tolerance
# two test points inside the water column (the problem's three sit in the
# obstacle's path, with no fluid near them at t = 0)
EXTRA_TESTPOINTS = ((0.2, 0.335, 0.1), (0.3, 0.2, 0.2))
TIMES = (0.0, 0.005, 0.01)
STATE_KEYS = ("pos", "vel", "rho", "mass", "info", "id")


def _problem(get):
    p = get("DamBreak3D")({"deltap": DELTAP})
    for tp in EXTRA_TESTPOINTS:
        p.add_testpoint(tp)
    grid, state = p.build()
    return p, grid, state


def _states_and_bodies(jp, jst):
    """Three states and body states, as numpy, from a seed."""
    rng = np.random.default_rng(7)
    base = {k: np.asarray(getattr(jst, k)) for k in STATE_KEYS}
    jb = jbodies.init_bodies_state(jp.body_specs(), jst)
    out = []
    for _ in TIMES:
        d = dict(base)
        d["vel"] = (base["vel"] + rng.normal(0, 0.3, base["vel"].shape)).astype(np.float32)
        d["rho"] = (base["rho"] + rng.uniform(-1e-3, 1e-3, base["rho"].shape)
                    ).astype(np.float32)
        b = {k: np.asarray(getattr(jb, k)) for k in tbodies.BODY_FIELDS}
        for k in ("linvel", "angvel", "force", "torque"):
            b[k] = rng.normal(0, 1, b[k].shape).astype(np.float32)
        out.append((d, b))
    return out


def _dispatcher_kw(p, n_bodies, grid):
    return dict(vtk_every=0.005, vtklegacy_every=0.005, text_every=0.01,
                hot_every=0.005, keep_hot=3, gages=p.gages, n_bodies=n_bodies,
                grid=grid)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both dispatchers write the same three states; returns the two output
    directories and the states."""
    jp, jgrid, jst = _problem(jget_problem)
    tp, tgrid, _ = _problem(get_problem)
    jdir = str(tmp_path_factory.mktemp("jax_out"))
    tdir = str(tmp_path_factory.mktemp("torch_out"))
    jw = JDispatcher(jdir, jp.fw.finalize(), **_dispatcher_kw(jp, 1, jgrid))
    tw = TDispatcher(tdir, tp.fw.finalize(), **_dispatcher_kw(tp, 1, tgrid))
    states = _states_and_bodies(jp, jst)
    for i, (t, (d, b)) in enumerate(zip(TIMES, states)):
        last = i == len(TIMES) - 1
        jw.maybe_write(t, jst.replace(**{k: jnp.asarray(v) for k, v in d.items()}),
                       dt=1e-4, iterations=10 * i, force=last,
                       bodies=jbodies.BodiesState(**{k: jnp.asarray(v) for k, v in b.items()}))
        tw.maybe_write(t, state_from_numpy(d), dt=1e-4, iterations=10 * i, force=last,
                       bodies=bodies_from_numpy(b))
    tw.close()
    return jdir, tdir, states


def _files(root):
    return sorted(os.path.relpath(f, root)
                  for f in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                  if os.path.isfile(f))


def test_file_sets_match(written):
    jdir, tdir, _ = written
    files = _files(tdir)
    assert files == _files(jdir)
    for f in ("summary.txt", "energy.txt", "testpoints.txt", "rbdata.txt",
              "objectforces.txt", "data/PART.pvd", "data/VTUinp.pvd",
              "data/PART_00002.vtu", "data/PART_00002.vtk", "data/PART_00001.txt",
              "hot_00001.npz"):
        assert f in files, f
    for pvd in ("data/PART.pvd", "data/VTUinp.pvd"):
        with open(os.path.join(tdir, pvd)) as a, open(os.path.join(jdir, pvd)) as b:
            assert a.read() == b.read(), pvd


def _close(got, want, what, rtol, atol_frac=0.0):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("kind", ["vtu", "vtk"])
def test_particle_files_match(written, kind):
    """Every frame of each format, read back with the JAX readers."""
    jdir, tdir, _ = written
    reader = read_vtu if kind == "vtu" else read_vtk_legacy
    frames = sorted(glob.glob(os.path.join(jdir, "data", f"PART_*.{kind}")))
    assert len(frames) == 3
    for jf in frames:
        want = reader(jf)
        got = reader(os.path.join(tdir, "data", os.path.basename(jf)))
        assert sorted(got) == sorted(want)
        info = want["Info"] if kind == "vtu" else want["Type+flags"]
        tp = (np.asarray(info).astype(np.int64) & 7) == 3
        assert tp.sum() == 5
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            if k in ("Pressure", "Velocity"):
                # test-point rows: the interpolated values
                _close(got[k][tp], want[k][tp], k, **POST)
                g, w = got[k][~tp], want[k][~tp]
            else:
                g, w = got[k], want[k]
            if k in ("Pressure", "Density"):
                _close(g, w, k, RTOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        assert np.abs(want["Velocity"][tp]).max() > 0  # test points in the fluid


@pytest.mark.parametrize("name", ["energy.txt", "rbdata.txt", "objectforces.txt",
                                  "testpoints.txt", "data/PART_00000.txt"])
def test_series_match(written, name):
    jdir, tdir, _ = written
    want = np.loadtxt(os.path.join(jdir, name), ndmin=2)
    got = np.loadtxt(os.path.join(tdir, name), ndmin=2)
    assert got.shape == want.shape and len(got) > 0
    if name == "testpoints.txt":
        assert len(got) == 5 * len(TIMES)
    # per column: rtol 1e-6, and 1e-6 of the column's largest value for
    # components that the interpolation sums to near zero
    for c in range(got.shape[1]):
        _close(got[:, c], want[:, c], f"{name} column {c}", RTOL, 1e-6)


def test_summary_keys_match(written):
    jdir, tdir, _ = written

    def keys(root):
        with open(os.path.join(root, "summary.txt")) as f:
            return [ln.split("=")[0].strip() for ln in f if not ln.startswith("#")]

    assert keys(tdir) == keys(jdir)


def test_wave_gages_match(tmp_path):
    """Gages imply surface detection in both packages' ``build``, and the
    forced writes of two states give the same WaveGage.txt: the surface
    flags of the two packages agree, and the elevations are float64 host
    sums over them.  DamBreak3D at dp 0.1 (834 particles)."""
    gages = ((0.2, 0.335), (0.3, 0.3, 0.05), (1.2, 0.3))
    probs = []
    for get in (jget_problem, get_problem):
        p = get("DamBreak3D")({"deltap": 0.1})
        for g in gages:
            p.add_gage(*g)
        probs.append((p, *p.build()))
    (jp, jgrid, jst), (tp, tgrid, _) = probs
    assert [int(x) for x in tp.fw.postprocess] == [int(x) for x in jp.fw.postprocess] == [1, 2]
    rng = np.random.default_rng(13)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(gages=jp.gages, n_bodies=0)
    jw = JDispatcher(jdir, jp.fw.finalize(), grid=jgrid, **kw)
    tw = TDispatcher(tdir, tp.fw.finalize(), grid=tgrid, **kw)
    for t in (0.0, 0.01):
        vel = rng.normal(0, 0.3, jst.vel.shape).astype(np.float32)
        js = jst.replace(vel=jnp.asarray(vel))
        jw.maybe_write(t, js, force=True)
        tw.maybe_write(t, state_from_numpy(js), force=True)
    tw.close()
    for name in ("WaveGage.txt", "energy.txt"):
        want = np.loadtxt(os.path.join(jdir, name), ndmin=2)
        got = np.loadtxt(os.path.join(tdir, name), ndmin=2)
        assert got.shape == want.shape == (2, 4), name
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_hotfile_interop(tmp_path, direction):
    """A checkpoint with an extra buffer and a body state, written by one
    package and loaded by the other."""
    rng = np.random.default_rng(3)
    n = 64
    d = dict(pos=rng.uniform(0, 1, (n, 3)).astype(np.float32),
             vel=rng.normal(0, 1, (n, 3)).astype(np.float32),
             rho=rng.normal(0, 1e-3, n).astype(np.float32),
             mass=rng.uniform(0.1, 0.2, n).astype(np.float32),
             # bit 31 set: the port's int32 word is negative
             info=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
             id=np.arange(n, dtype=np.uint32) + np.uint32(2**31),
             extras={"energy": rng.uniform(0, 1, n).astype(np.float32)})
    body = {k: rng.normal(0, 1, (2, 4 if k == "quat" else 3)).astype(np.float32)
            for k in tbodies.BODY_FIELDS}
    head = dict(t=0.0123, dt=1.5e-4, iterations=170)
    path = str(tmp_path / "hot.npz")
    if direction == "jax_to_torch":
        from gpusph_tpu.state import ParticleState as JState

        js = JState(**{k: jnp.asarray(d[k]) for k in STATE_KEYS},
                    extras={k: jnp.asarray(v) for k, v in d["extras"].items()})
        jb = jbodies.BodiesState(**{k: jnp.asarray(v) for k, v in body.items()})
        jhot.save_hotfile(path, js, body_state=jbodies.bodies_to_dict(jb), **head)
        st, header, bdict = thot.load_hotfile(path)
        got = state_to_numpy(st)
        got_body = tbodies.bodies_from_dict(bdict)
        got_body = {k: getattr(got_body, k).numpy() for k in tbodies.BODY_FIELDS}
    else:
        tb = bodies_from_numpy(body)
        thot.save_hotfile(path, state_from_numpy(d), body_state=tbodies.bodies_to_dict(tb),
                          **head)
        js, header, bdict = jhot.load_hotfile(path)
        got = {k: np.asarray(getattr(js, k)) for k in STATE_KEYS}
        got["extras"] = {k: np.asarray(v) for k, v in js.extras.items()}
        got_body = {k: np.asarray(v) for k, v in
                    vars(jbodies.bodies_from_dict(bdict)).items() if k in body}
    for k in STATE_KEYS:
        assert got[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(got[k], d[k], err_msg=k)
    np.testing.assert_array_equal(got["extras"]["energy"], d["extras"]["energy"])
    assert header == dict(version=1, buffer_count=7, particle_count=n, body_count=0,
                          numOpenBoundaries=0, iterations=170, t=0.0123, dt=1.5e-4)
    for k, v in body.items():
        np.testing.assert_array_equal(got_body[k], v, err_msg=k)


def test_read_vtu_reads_the_jax_files(written):
    """The port's readers read the JAX package's frames."""
    jdir, tdir, _ = written
    for ext, mine, theirs in (("vtu", tvtk.read_vtu, read_vtu),
                              ("vtk", tvtk.read_vtk_legacy, read_vtk_legacy)):
        path = os.path.join(jdir, "data", f"PART_00001.{ext}")
        got, want = mine(path), theirs(path)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ext} {k}")


def test_cli_checkpoint_and_resume(tmp_path):
    """The CLI on the CPU: layout, the last frame against the final
    checkpoint, and a resume from the middle hotfile that ends bit-identical
    to the straight run."""
    argv = ["DamBreak3D", "--deltap", str(DELTAP), "--maxiter", "20",
            "--checkpoint-every", "0.002", "--device", "cpu"]
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    assert cli.main(argv + ["--dir", straight]) == 0
    files = _files(straight)
    for f in ("summary.txt", "energy.txt", "testpoints.txt", "rbdata.txt",
              "objectforces.txt", "data/PART.pvd", "data/PART_00000.vtu",
              "hot_00000.npz", "hot_00001.npz"):
        assert f in files, f
    hots = sorted(glob.glob(os.path.join(straight, "hot_*.npz")))
    iters = [thot.load_hotfile(h)[1]["iterations"] for h in hots]
    assert iters == [10, 20]

    # the final write is forced: the last frame is the final state
    final, header, _ = thot.load_hotfile(hots[-1])
    fin = state_to_numpy(final)
    frame = tvtk.read_vtu(sorted(glob.glob(os.path.join(straight, "data", "PART_*.vtu")))[-1])
    act = final.active.numpy()
    tp = (fin["info"][act] & 7) == 3
    for k, v in (("pos", fin["pos"]), ("Mass", fin["mass"]), ("Id", fin["id"]),
                 ("Info", fin["info"])):
        np.testing.assert_array_equal(frame[k], v[act], err_msg=k)
    np.testing.assert_array_equal(frame["Velocity"][~tp], fin["vel"][act][~tp])
    tp_rows = np.loadtxt(os.path.join(straight, "testpoints.txt"))
    last = tp_rows[tp_rows[:, 0] == tp_rows[-1, 0]]
    assert len(last) == 3 and np.isfinite(tp_rows).all()
    np.testing.assert_array_equal(frame["Velocity"][tp], last[:, 5:8].astype(np.float32))
    assert np.isfinite(np.loadtxt(os.path.join(straight, "energy.txt"))).all()

    assert cli.main(argv + ["--dir", resumed, "--resume", hots[0]]) == 0
    rhot = sorted(glob.glob(os.path.join(resumed, "hot_*.npz")))[-1]
    again, rheader, rbody = thot.load_hotfile(rhot)
    _, _, body = thot.load_hotfile(hots[-1])
    assert rheader == header
    assert rbody == body
    got = state_to_numpy(again)
    for k in STATE_KEYS:
        np.testing.assert_array_equal(got[k], fin[k], err_msg=k)
