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

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "gpusph_tpu")


def _port_sources():
    files = sorted((ROOT / "gpusph_tpu_torch").rglob("*.py"))
    assert len(files) >= 15
    return files + [ROOT / "chip_smoke.py"]


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
    """make_sim_chunk names the missing slice instead of skipping it."""
    import dataclasses

    from gpusph_tpu_torch.defs import FilterType, SPHFormulation

    p, grid, _ = _dambreak_small()
    fw = p.fw.finalize()
    with pytest.raises(NotImplementedError, match="filters"):
        make_sim_chunk(dataclasses.replace(fw, filters=((FilterType.MLS, 10),)), grid)
    with pytest.raises(NotImplementedError, match="Grenier"):
        make_sim_chunk(dataclasses.replace(fw, sph_formulation=SPHFormulation.SPH_GRENIER),
                       grid)
    with pytest.raises(NotImplementedError, match="plane boundaries"):
        get_problem("DamBreak3D")({"deltap": 0.1, "use_planes": True})
