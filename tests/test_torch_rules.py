"""Rules of the port: it imports no JAX and nothing of the JAX package, and
its entry points run on the CUDA card unless the caller asks for the CPU."""
import ast
import pathlib

import jax  # noqa: F401  (both packages are importable side by side)
import pytest
import torch

import gpusph_tpu_torch
from gpusph_tpu_torch import cli
from gpusph_tpu_torch.integrator import Simulator, make_sim_chunk, resolve_device
from gpusph_tpu_torch.problems.base import get_problem
from gpusph_tpu_torch.problems.catalog import NOT_PORTED
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "gpusph_tpu")


def _port_sources():
    """The port, chip_smoke.py, the port's chip scripts and the tests that
    run where JAX is not installed (on the card's machine)."""
    files = sorted((ROOT / "gpusph_tpu_torch").rglob("*.py"))
    assert len(files) >= 15
    return files + [ROOT / "chip_smoke.py", ROOT / "scripts" / "sweep_forces_cuda.py",
                    ROOT / "scripts" / "ab_chip_smoke.py",
                    ROOT / "scripts" / "validate_poiseuille_torch.py",
                    ROOT / "scripts" / "validate_lithostatic_torch.py",
                    ROOT / "tests" / "test_torch_forces_gpu.py",
                    ROOT / "tests" / "test_torch_plan_invariants.py",
                    ROOT / "tests" / "torch_threads.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_package_location():
    assert pathlib.Path(gpusph_tpu_torch.__file__).parent == ROOT / "gpusph_tpu_torch"


def _dambreak_small():
    p = get_problem("DamBreak3D")({"deltap": 0.1})
    grid, state = p.build()
    return p, grid, state


def test_simulator_defaults_to_cuda():
    """With no device the Simulator takes the card; without one it raises
    and never runs on the CPU."""
    p, grid, _ = _dambreak_small()
    if torch.cuda.is_available():
        sim = Simulator(p.fw, grid, bodies_specs=p.body_specs())
        assert sim.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Simulator(p.fw, grid, bodies_specs=p.body_specs())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["DamBreak3D", "--deltap", "0.1", "--maxiter", "10"])
    sim = Simulator(p.fw, grid, bodies_specs=p.body_specs(), device="cpu")
    assert sim.device == torch.device("cpu")


def test_unported_configurations_raise():
    """make_sim_chunk names the missing slice instead of skipping it; the
    filters, SPS, Grenier, a gravity callback, the granular rheology and a
    DEM terrain build (the general pair path takes all but the filters and
    the DEM), and so do SA boundaries, on the gamma-quadrature path and with
    density summation; only k-epsilon and open boundaries raise, with
    density summation too."""
    import dataclasses

    from gpusph_tpu_torch.defs import (BoundaryType, FilterType, RheologyType, SimFlags,
                                       SPHFormulation, TurbulenceModel)

    p, grid, _ = _dambreak_small()
    fw = p.fw.finalize()
    make_sim_chunk(dataclasses.replace(fw, filters=((FilterType.MLS, 10),)), grid)
    make_sim_chunk(dataclasses.replace(
        fw, visc=dataclasses.replace(fw.visc, turbmodel=TurbulenceModel.SPS)), grid)
    make_sim_chunk(dataclasses.replace(fw, sph_formulation=SPHFormulation.SPH_GRENIER),
                   grid)
    make_sim_chunk(dataclasses.replace(fw, gcallback=lambda t: (t, t, t)), grid)
    make_sim_chunk(dataclasses.replace(fw, visc=dataclasses.replace(
        fw.visc, rheologytype=RheologyType.GRANULAR,
        turbmodel=TurbulenceModel.LAMINAR_FLOW)), grid)
    make_sim_chunk(dataclasses.replace(fw, dem=((0.0,),)), grid)
    sa = dataclasses.replace(fw, boundarytype=BoundaryType.SA_BOUNDARY)
    make_sim_chunk(sa, grid)
    dsum = dataclasses.replace(sa, flags=fw.flags | SimFlags.ENABLE_DENSITY_SUM)
    make_sim_chunk(dsum, grid)
    for bad, match in (
            (dataclasses.replace(sa, visc=dataclasses.replace(
                fw.visc, turbmodel=TurbulenceModel.KEPSILON)), "k-epsilon"),
            (dataclasses.replace(dsum, visc=dataclasses.replace(
                fw.visc, turbmodel=TurbulenceModel.KEPSILON)), "k-epsilon"),
            (dataclasses.replace(fw, io=((0.0,),)), "open boundaries"),
            (dataclasses.replace(dsum, io=((0.0,),)), "open boundaries")):
        with pytest.raises(NotImplementedError, match=match):
            make_sim_chunk(bad, grid)


def test_new_modules_fall_under_the_import_ban():
    """The output path's modules are globbed with the rest of the package."""
    names = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    for mod in ("io/vtk.py", "io/writers.py", "io/hotfile.py", "ops/pair.py",
                "ops/postprocess.py", "repacking.py", "ops/filters.py", "ops/visc.py",
                "ops/forces.py", "ops/grenier.py", "ops/jacobi.py", "ops/dem.py",
                "geometry/stl.py", "problems/generic.py", "ops/sa.py",
                "geometry/sa_mesh.py", "ops/density_sum.py"):
        assert f"gpusph_tpu_torch/{mod}" in names, mod


@pytest.mark.parametrize("path", ["gpusph_tpu_torch/ops/planes.py",
                                  "scripts/validate_poiseuille_torch.py",
                                  "scripts/validate_lithostatic_torch.py"])
def test_catalog_slice_files_fall_under_the_import_ban(path):
    """The plane pass and the two validation scripts are checked with the
    rest of the port."""
    assert path in {p.relative_to(ROOT).as_posix() for p in _port_sources()}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_unported_problems_name_their_slice(name):
    """The JAX catalog's problems that the port does not hold are not in its
    registry; asking for one names what it waits for (DEM, SA boundaries,
    ...)."""
    from gpusph_tpu_torch.problems.base import PROBLEM_REGISTRY

    with pytest.raises(NotImplementedError, match="not ported yet") as err:
        get_problem(name)
    assert NOT_PORTED[name] in str(err.value)
    assert name not in PROBLEM_REGISTRY


def test_only_sa_problems_wait():
    """The problems still waiting are the SA family: each needs SA
    boundaries (ROADMAP item 8)."""
    assert NOT_PORTED
    for name, text in NOT_PORTED.items():
        assert "SA boundaries" in text, name


def test_every_jax_problem_is_ported_or_named():
    """The port's registry and NOT_PORTED together cover the JAX catalog."""
    from gpusph_tpu.problems.base import PROBLEM_REGISTRY as JAX_REGISTRY
    from gpusph_tpu.problems.base import get_problem as jget_problem
    from gpusph_tpu_torch.problems.base import PROBLEM_REGISTRY

    jget_problem("DamBreak3D")  # registers the JAX catalog
    get_problem("DamBreak3D")
    jax_names = {n for n in JAX_REGISTRY if not n.startswith("_")}
    assert not set(PROBLEM_REGISTRY) & set(NOT_PORTED)
    assert jax_names == set(PROBLEM_REGISTRY) | set(NOT_PORTED)


@pytest.mark.parametrize("argv,match", [
    (["--ndev", "2"], "multi-GPU slice"),
    (["--debug", "timing"], r"chip_smoke.py \[4 layers\]"),
], ids=["ndev", "debug_timing"])
def test_unported_cli_flags_raise(tmp_path, argv, match):
    """Unported flags name their slice, before anything runs or is written."""
    out = tmp_path / "out"
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["DamBreak3D", "--deltap", "0.1", "--maxiter", "10", "--device", "cpu",
                  "--dir", str(out)] + argv)
    assert not out.exists()


def test_flux_postprocess_raises():
    import dataclasses

    from gpusph_tpu_torch.defs import PostProcessType
    from gpusph_tpu_torch.ops.postprocess import make_write_postprocess

    p, grid, _ = _dambreak_small()
    fw = dataclasses.replace(p.fw.finalize(),
                             postprocess=(PostProcessType.FLUX_COMPUTATION,))
    with pytest.raises(NotImplementedError, match="open-boundary slice"):
        make_write_postprocess(fw, grid)


@pytest.mark.parametrize("argv", [
    ["--checkpoint-every", "0.002"],
    ["--repack-only"],
], ids=["checkpoints", "repack_only"])
def test_cli_output_paths_default_to_cuda(tmp_path, argv):
    """Without --device the CLI's output, checkpoint and repack paths take
    the card: without one they raise before writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CPU-only case does not apply")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["DamBreak3D", "--deltap", "0.1", "--maxiter", "10",
                  "--dir", str(out)] + argv)
    assert not out.exists()
