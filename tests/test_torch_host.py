"""Port parity, host layer: the PyTorch package's copied host modules
produce the JAX package's mesh, device-grid arrays and f64 host operator
data bit for bit, and the port imports without jax.

Reference analog: the mesh and CSR pencil the reference hands to ARPACK
(the reference's mesh.py, solver_fem.py:129-175).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pl_fem_tpu.config import MeshConfig as JMeshConfig
from pl_fem_tpu.config import SimulationConfig as JSimulationConfig
from pl_fem_tpu.models import MCFGeometry as JMCFGeometry
from pl_fem_tpu.ops.femgrid import MeshGenerator as JMeshGenerator
from pl_fem_tpu.ops.femgrid import export_device_grid as j_export
from pl_fem_tpu.ops.host_assembly import \
    build_host_vector3_family as j_family
from pl_fem_tpu_torch.config import (MeshConfig, SimulationConfig,
                                     SolverConfig, solver_preset)
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid
from pl_fem_tpu_torch.ops.host_assembly import build_host_vector3_family

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def grids():
    """The same small config-1 mesh (7-core hex) from both packages."""
    args = (7, 8.0, 1.5, 1.535, 1.0)
    jcfg = JSimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                             mesh=JMeshConfig(bucket_rounding=256))
    cfg = SimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                           mesh=MeshConfig(bucket_rounding=256))
    jg = JMCFGeometry(*args, wavelength_um=1.55)
    g = MCFGeometry(*args, wavelength_um=1.55)
    jdg = j_export(JMeshGenerator.generate(jg, 0.3, jcfg), 256)
    dg = export_device_grid(MeshGenerator.generate(g, 0.3, cfg), 256)
    return jg, jdg, g, dg


def test_device_grid_bit_equal(grids):
    _, jdg, _, dg = grids
    names = [f.name for f in dataclasses.fields(dg)]
    assert names == [f.name for f in dataclasses.fields(jdg)]
    for name in names:
        a, b = getattr(jdg, name), getattr(dg, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), name
        else:
            assert a == b, name


def test_host_family_csr_bit_equal(grids):
    jg, jdg, g, dg = grids
    jf = j_family(jdg, jg.eps_params(), 1.0)
    f = build_host_vector3_family(dg, g.eps_params(), 1.0)
    assert np.array_equal(jf.pat.indptr, f.pat.indptr)
    assert np.array_equal(jf.pat.indices, f.pat.indices)
    for name in ("d_core", "d_clad", "d_u"):
        assert np.array_equal(getattr(jf, name), getattr(f, name)), name
    for name in ("M3", "Dxx", "Dyy", "Dxy", "Msig"):
        a, b = getattr(jf, name), getattr(f, name)
        assert (a != b).nnz == 0, name


def test_mesh_cache_is_keyed_by_the_shape():
    """One cache entry serves a cross-section at every wavelength and
    index (the mesh depends on its shape alone); another core radius is
    another mesh."""
    cfg = SimulationConfig(mesh_min_points=200, mesh_target_points=200,
                           mesh=MeshConfig(bucket_rounding=128))
    MeshGenerator.clear_cache()
    grid = MeshGenerator.generate(MCFGeometry(7, 8.0, 1.5, 1.535, 1.0,
                                              wavelength_um=1.55), 0.3, cfg)
    same = MCFGeometry(7, 8.0, 1.5, 1.47, 1.0, wavelength_um=1.62)
    assert MeshGenerator.generate(same, 0.3, cfg) is grid
    other = MCFGeometry(7, 8.0, 1.4, 1.535, 1.0, wavelength_um=1.55)
    assert MeshGenerator.generate(other, 0.3, cfg) is not grid
    MeshGenerator.clear_cache()


def test_polish_residuals_are_the_pencils(grids, monkeypatch):
    """``quadratic_subspace``'s residuals (sparse products on torch's
    threads, formed a slab of rows at a time) are those of the full
    pencil applied by scipy to each returned field, with one slab or
    many."""
    from pl_fem_tpu_torch.ops import host_assembly as ha

    _, _, g, dg = grids
    hv = ha.build_host_vector3(dg, g.eps_params(), 1.0)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((hv.M3.shape[0], 16))
    mask = (rng.random(X.shape[0]) > 0.1).astype(np.float64)
    betas, H, _, res = ha.quadratic_subspace(hv, X, g.k0, -1e9, 1e9, mask)
    assert len(betas) >= 4
    plain = [np.linalg.norm(mask * (hv.A_of(b) @ h - g.k0**2 * (hv.M3 @ h)))
             / (g.k0**2 * np.linalg.norm(h)) for b, h in zip(betas, H.T)]
    np.testing.assert_allclose(res, plain, rtol=1e-9)
    monkeypatch.setattr(ha, "_SLAB", 1000)
    assert X.shape[0] > 3 * ha._SLAB
    np.testing.assert_allclose(
        ha.quadratic_subspace(hv, X, g.k0, -1e9, 1e9, mask)[3], res,
        rtol=1e-12)


def test_solver_config_trimmed_and_presets():
    names = {f.name for f in dataclasses.fields(SolverConfig)}
    for dropped in ("scalar_maxiter", "dtype_filter", "dtype_rr",
                    "apply_layout", "accumulate", "xfer_dtype"):
        assert dropped not in names
    assert SolverConfig().backend == "device"
    assert solver_preset("fast").beta_passes == 1
    bal = solver_preset("balanced", cheb_degree=200)
    assert (bal.beta_passes, bal.polish_qres_tol, bal.qres_max_rounds,
            bal.cheb_degree) == (2, 2.5e-4, 2, 200)
    with pytest.raises(ValueError):
        solver_preset("turbo")


def test_unknown_backend_raises(grids):
    from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver

    _, _, g, dg = grids
    for backend in ("tpu", "arpack"):
        cfg = SimulationConfig(solver=SolverConfig(backend=backend,
                                                   device="cpu"))
        with pytest.raises(ValueError, match="backend"):
            TrueVectorialMaxwellSolver.solve_sweep([g], dg, 4, cfg)
        with pytest.raises(ValueError, match="backend"):
            TrueVectorialMaxwellSolver(g, config=cfg) \
                .solve_vectorial_modes(dg, 4)


_BLOCK_JAX = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "pl_fem_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import pl_fem_tpu_torch
import pl_fem_tpu_torch.solvers.vectorial
import pl_fem_tpu_torch.solvers.scalar
import pl_fem_tpu_torch.ops.eig
import pl_fem_tpu_torch.ops.kernels
import pl_fem_tpu_torch.ops.triton_kernels
import pl_fem_tpu_torch.ops.cuda_kernels
import pl_fem_tpu_torch.physics
import pl_fem_tpu_torch.physics.cmt
import pl_fem_tpu_torch.dataset
import pl_fem_tpu_torch.cli
import pl_fem_tpu_torch.parallel
import pl_fem_tpu_torch.utils
for name in pl_fem_tpu_torch.__all__:
    getattr(pl_fem_tpu_torch, name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pl_fem_tpu"))
assert not bad, bad
assert pl_fem_tpu_torch.TrueVectorialMaxwellSolver.__name__ == \\
    "TrueVectorialMaxwellSolver"
assert pl_fem_tpu_torch.ScalarHelmholtzSolver.__name__ == \\
    "ScalarHelmholtzSolver"
print("ok")
"""


def test_port_imports_without_jax():
    """The port's modules (solver, kernels, physics, dataset engine and
    CLI) import in a process where jax and the JAX package cannot be
    imported at all."""
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax():
    for path in (REPO / "pl_fem_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import pl_fem_tpu ",
                                     "from pl_fem_tpu ",
                                     "from pl_fem_tpu.")), (path, line)
    smoke = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "from jax" not in smoke
    assert "from pl_fem_tpu." not in smoke


def test_launchers_set_one_shared_limit():
    """The row-owned kernels' launchers (K1, K3, K5) set the dynamic
    shared-memory limit only through ``set_shared_limit``, to the one
    fixed value of csrc/shared_limit.cuh. A limit set to each launch's
    own size races between the dataset engine's two sweep threads: one
    lowers it under the other's request between that one's set and its
    launch, which then fails (ROADMAP C). The card test
    (test_row_owned_kernels_from_two_threads) does not catch the race
    every time, so the sources are held to the fix here."""
    csrc = REPO / "pl_fem_tpu_torch" / "ops" / "csrc"
    header = (csrc / "shared_limit.cuh").read_text()
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize,\n" \
           "        (int)kMaxShared);" in header
    for src in sorted(csrc.glob("*.cu")):
        assert "cudaFuncSetAttribute" not in src.read_text(), src.name
    for name in ("apply_vector3.cu", "mass_apply.cu", "apply_stacked.cu"):
        text = (csrc / name).read_text()
        assert '#include "shared_limit.cuh"' in text, name
        assert text.count("set_shared_limit(") == 1, name


@pytest.mark.parametrize("module", ["", ".solvers", ".utils", ".parallel"])
def test_port_exports_every_reference_name(module):
    """Every public name of the JAX package's top level, ``solvers``,
    ``utils`` and ``parallel`` (their ``__all__``) exists in the port's
    counterpart, the lazy ones included."""
    import importlib

    ref = importlib.import_module("pl_fem_tpu" + module)
    port = importlib.import_module("pl_fem_tpu_torch" + module)
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert set(ref.__all__) <= set(port.__all__)


def test_device_trace_writes_a_trace(tmp_path):
    """``utils.device_trace`` traces a small block of torch work on the
    CPU and leaves a Chrome trace under its directory, with the
    program's spans in it (a ``PhaseTimer`` phase here)."""
    import json

    from pl_fem_tpu_torch.utils import PhaseTimer, device_trace

    with device_trace(tmp_path / "trace") as prof:
        with PhaseTimer().phase("probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert [e["name"] for e in events
            if e.get("name", "").startswith("pl_fem.")] == ["pl_fem.probe"]
