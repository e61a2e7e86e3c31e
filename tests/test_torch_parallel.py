"""The design-parallel sweep: ``solve_sweep(mesh=)`` over a set of devices,
held against the port's unsplit sweep and the JAX package's sharded one.

On the small mesh of tests/test_parallel.py's ``small_designs`` (3 cores,
``mesh_min_points`` 200, B = 8 wavelengths 1.50-1.64 um,
``bucket_rounding`` 128; ~4.4k DOFs). Both packages start from the same
subspace: the JAX package draws it from ``jax.random.PRNGKey(11)``
(pl_fem_tpu/solvers/vectorial.py:686) and the tests hand those numbers
to the port as ``X0``. The filter is cut to degree 30 with B^-1 degree 1
and k = 8 columns (n_modes 4 + 4 extra), so that a sweep of the port's
plain twins takes seconds on one CPU thread; the JAX package's own
``test_sharded_sweep_matches_single_device`` runs degree 120.

The split computes per design what the unsplit sweep computes, so the
two agree to the last bit on the CPU (measured: 0.0 relative in n_eff
over 2 and 4 slices, and in the padded B = 3 sweep); the bound is 1e-6
relative. Against the JAX package's sharded sweep the bound is 2e-5,
that of the JAX package's own sharded-vs-single test, set by its f16
device->host subspace slab (measured 5.7e-6 at these settings).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_fem_tpu.config import MeshConfig as JMeshConfig
from pl_fem_tpu.config import SimulationConfig as JSimulationConfig
from pl_fem_tpu.config import SolverConfig as JSolverConfig
from pl_fem_tpu.models import MCFGeometry as JMCFGeometry
from pl_fem_tpu.ops.femgrid import MeshGenerator as JMeshGenerator
from pl_fem_tpu.ops.femgrid import export_device_grid as j_export
from pl_fem_tpu.ops.kernels import _sweep_gate_maxres as j_gate
from pl_fem_tpu.parallel import design_mesh as j_design_mesh
from pl_fem_tpu.solvers import TrueVectorialMaxwellSolver as JSolver
from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig, SolverConfig
from pl_fem_tpu_torch.dataset import generator as tgen
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops import kernels as tk
from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid
from pl_fem_tpu_torch.parallel import design_mesh
from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver
from pl_fem_tpu_torch.solvers import vectorial as tv

torch.set_num_threads(1)

WLS = (1.50, 1.52, 1.54, 1.56, 1.58, 1.60, 1.62, 1.64)
N_MODES = 4
SPLIT_RTOL = 1e-6
JAX_RTOL = 2e-5
SOLVER_KW = dict(cheb_degree=30, cheb_passes=2, beta_passes=1,
                 bootstrap=False, binv_degree=1, extra_vectors=4)
MESH_KW = dict(mesh_min_points=200, mesh_target_points=900)


def _cfg(**solver):
    return SimulationConfig(**MESH_KW, mesh=MeshConfig(bucket_rounding=128),
                            solver=SolverConfig(device="cpu", **{
                                **SOLVER_KW, **solver}))


@pytest.fixture(scope="module")
def small():
    """The small designs and mesh in both packages (the grids checked
    equal), the port's config and the JAX start block (3 Dp, 8, k)."""
    jcfg = JSimulationConfig(**MESH_KW, mesh=JMeshConfig(bucket_rounding=128),
                             solver=JSolverConfig(backend="tpu", **SOLVER_KW))
    jgs = [JMCFGeometry(3, 8.0, 1.3, 1.53, 1.0, wavelength_um=w)
           for w in WLS]
    gs = [MCFGeometry(3, 8.0, 1.3, 1.53, 1.0, wavelength_um=w) for w in WLS]
    jdg = j_export(JMeshGenerator.generate(jgs[0], 0.35, jcfg), 128)
    cfg = _cfg()
    dg = export_device_grid(MeshGenerator.generate(gs[0], 0.35, cfg), 128)
    assert np.array_equal(jdg.elem_dofs, dg.elem_dofs)
    k = N_MODES + cfg.solver.extra_vectors
    X0 = np.asarray(jax.random.normal(
        jax.random.PRNGKey(11), (3 * dg.n_dofs_padded, len(gs), k),
        dtype=jnp.float32))
    return dict(jcfg=jcfg, jgs=jgs, jdg=jdg, cfg=cfg, gs=gs, dg=dg, X0=X0)


@pytest.fixture(scope="module")
def sweeps(small):
    """The port's sweep of the 8 designs from the JAX start, unsplit and
    over 2 and 4 CPU slices, each run once (by ``n`` slices)."""
    done = {}

    def run(n):
        if n not in done:
            mesh = None if n == 1 else design_mesh(["cpu"] * n)
            done[n] = TrueVectorialMaxwellSolver.solve_sweep(
                small["gs"], small["dg"], N_MODES, small["cfg"],
                X0=small["X0"], mesh=mesh)
        return done[n]
    return run


def _max_rel(ref, out):
    """The largest relative n_eff difference of two sweeps' results,
    which must hold the same number of modes per design (and some)."""
    worst = 0.0
    for mr, mo in zip(ref, out, strict=True):
        assert len(mo) == len(mr) > 0
        ne_r = np.array([m["n_eff"] for m in mr])
        ne_o = np.array([m["n_eff"] for m in mo])
        worst = max(worst, float(np.abs(ne_o - ne_r).max() / ne_r.max()))
    return worst


@pytest.mark.parametrize("n", [2, 4])
def test_split_matches_unsplit(sweeps, monkeypatch, n):
    """The 8 designs over ``n`` CPU slices against the unsplit sweep from
    the same start: the filter sees the mesh and its slices take 8 / n
    designs each, and n_eff agrees within 1e-6 relative (measured 0.0)."""
    widths = []
    rr = tk.cheb_sweep_rr_impl

    def rr_seen(qs, gs, mask, parks, betas, alpha, Xff, *a, **kw):
        widths.append(Xff.shape[1])
        return rr(qs, gs, mask, parks, betas, alpha, Xff, *a, **kw)

    ref = sweeps(1)
    monkeypatch.setattr(tk, "cheb_sweep_rr_impl", rr_seen)
    out = sweeps(n)
    assert widths and set(widths) == {8 // n} and len(widths) % n == 0
    assert _max_rel(ref, out) <= SPLIT_RTOL


def test_split_matches_jax_sharded(small, sweeps):
    """The port's sweep over 2 CPU slices against the JAX package's sweep
    sharded over its 8 virtual CPU devices: the same modes, n_eff within
    2e-5 relative (measured 5.7e-6)."""
    ref = JSolver.solve_sweep(small["jgs"], small["jdg"], N_MODES,
                              small["jcfg"],
                              mesh=j_design_mesh(jax.devices()[:8]))
    assert _max_rel(ref, sweeps(2)) <= JAX_RTOL


def test_split_pads_nondivisible(small, monkeypatch):
    """B = 3 over 2 slices with beta_passes = 2 (as the JAX package's
    ``test_sharded_sweep_pads_nondivisible``): the sweep is padded to 4
    with the last design, every filter call of every round divides over
    the mesh (the active set padded to a multiple of it), 3 results come
    back, equal to the unsplit B = 3 sweep from the same start within
    1e-6 (measured 0.0), and the diagnostics keep designs < 3 only."""
    cfg = _cfg(beta_passes=2, qres_max_rounds=2)
    gs, dg = small["gs"][:3], small["dg"]
    X0 = small["X0"][:, :3]
    calls = []
    solve = tv.solve_lowest_sweep

    def seen(qs, *a, mesh=None, **kw):
        calls.append((qs.inv_eps.shape[0], mesh))
        return solve(qs, *a, mesh=mesh, **kw)

    ref = TrueVectorialMaxwellSolver.solve_sweep(gs, dg, N_MODES, cfg, X0=X0)
    monkeypatch.setattr(tv, "solve_lowest_sweep", seen)
    diags = {}
    out = TrueVectorialMaxwellSolver.solve_sweep(
        gs, dg, N_MODES, cfg, X0=X0, mesh=design_mesh(["cpu"] * 2),
        diag_out=diags)
    assert len(out) == 3 and all(out)
    assert calls and calls[0][0] == 4
    assert all(m is not None and m.size == 2 and b % 2 == 0
               for b, m in calls)
    assert all(i < 3 for i in diags)
    assert _max_rel(ref, out) <= SPLIT_RTOL


@pytest.mark.parametrize("idx,B,n,want", [
    ([0, 1, 2], 8, 1, [0, 1, 2, 2]), ([5], 8, 1, [5]),
    ([5], 8, 2, [5, 5]), ([0, 3, 5], 6, 2, [0, 3, 5, 5]),
    ([1, 2, 4], 6, 3, [1, 2, 4, 4, 4, 4]), ([0, 1, 2, 3, 4], 6, 3, [0, 1, 2, 3, 4, 4]),
    ([0, 1, 2, 3, 4], 12, 3, [0, 1, 2, 3, 4, 4, 4, 4, 4])])
def test_active_set_padding(idx, B, n, want):
    """A later round's active designs are padded with the last one to a
    power-of-two width, at least the mesh size and divisible by it, and
    at most B (as the JAX package's ``_pad_active``)."""
    mesh = None if n == 1 else design_mesh(["cpu"] * n)
    assert tv._pad_active(idx, B, mesh) == want


def test_single_design_takes_the_unsplit_path(small, monkeypatch):
    """B = 1 on a 2-slice mesh: the mesh shrinks to none and the filter
    runs unsplit."""
    meshes = []
    solve = tv.solve_lowest_sweep

    def seen(*a, mesh=None, **kw):
        meshes.append(mesh)
        return solve(*a, mesh=mesh, **kw)

    monkeypatch.setattr(tv, "solve_lowest_sweep", seen)
    out = TrueVectorialMaxwellSolver.solve_sweep(
        small["gs"][:1], small["dg"], N_MODES, small["cfg"],
        X0=small["X0"][:, :1], mesh=design_mesh(["cpu"] * 2))
    assert len(out) == 1 and out[0]
    assert meshes == [None]


def test_mesh_of_another_device_type_is_refused(small):
    """A mesh of CUDA devices for a sweep on the CPU raises: no slice
    moves to another kind of device than the config names."""
    with pytest.raises(ValueError, match="does not match"):
        TrueVectorialMaxwellSolver.solve_sweep(
            small["gs"][:2], small["dg"], N_MODES, small["cfg"],
            mesh=design_mesh(["cuda:0", "cuda:1"]))


def _tensors(x):
    """Every tensor of ``x`` (a tensor, a NamedTuple of them, nested, or
    a dataclass instance's fields)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def test_slices_hold_their_tensors_on_their_device(small):
    """``kernels._design_slices`` over a mesh whose second slice sits on
    another device than the sweep's (the meta device stands in for a
    second card): every tensor a slice holds (the grid topology with the
    K1 and K3 plans, the quadrature factors with its designs' 1/eps, the
    mask, the mass scaling, its per-design values and its fused state)
    lies on the slice's device, with its designs' rows, and the slice on
    the sweep's device shares the caller's grid tensors."""
    from pl_fem_tpu_torch.ops import assembly as ta
    from pl_fem_tpu_torch.parallel import DesignMesh

    cpu, meta = torch.device("cpu"), torch.device("meta")
    dg, B, k = small["dg"], 4, 5
    ga = ta.grid_to_device(dg, cpu)
    gs = ta.gather_scatter(ga)
    qs, diag = ta.assemble_vector3_sweep(
        ga, gs, [ta.eps_arrays(g.eps_params(), cpu) for g in small["gs"][:B]])
    per = [torch.arange(B, dtype=torch.float32) + i for i in range(4)]
    Xf = torch.randn((dg.n_dofs_padded, B, 3, k))
    parts = tk._design_slices(DesignMesh((cpu, meta)), qs, gs,
                              ga.interior_mask, diag, *per, Xf)
    assert [p.dev for p in parts] == [cpu, meta]
    for p in parts:
        held = _tensors(p)
        assert held and all(t.device == p.dev for t in held)
        assert p.Xf.shape == (dg.n_dofs_padded, 2, 3, k)
        assert p.Xf.is_contiguous() and p.qs.inv_eps.shape[0] == 2
    assert parts[0].gs is gs and parts[0].mask is ga.interior_mask
    assert torch.equal(parts[0].Xf, Xf[:, :2])
    assert torch.equal(parts[0].cuts, per[0][:2])


@pytest.mark.parametrize("case", ["one_slice_unwanted", "all_unwanted",
                                  "mixed"])
@pytest.mark.parametrize("n_wanted", [0, 3])
def test_split_gate_matches_reference(case, n_wanted):
    """The split sweep's pass gate (``kernels._split_gate`` over the
    slices' theta and res) equals the JAX package's ``_sweep_gate_maxres``
    on the whole (B, k) arrays, also where one slice has no wanted column
    (its own gate is its smallest residual, which a max over the slices'
    gates would mix in) and where no design has one."""
    rng = np.random.default_rng(11)
    B, k, n = 8, 6, 2
    theta = rng.uniform(0.0, 2.0, (B, k)).astype(np.float32)
    res = rng.uniform(1e-6, 1e-3, (B, k)).astype(np.float32)
    cuts = rng.uniform(0.5, 1.5, B).astype(np.float32)
    if case != "mixed":
        theta[4:] = 3.0                # the second slice: nothing wanted
        res[4:] = rng.uniform(1e-2, 1e-1, (4, k))
    if case == "all_unwanted":
        theta[:] = 3.0
    ref = float(j_gate(jnp.asarray(theta), jnp.asarray(res),
                       jnp.asarray(cuts), n_wanted=n_wanted))
    t, r, c = (torch.as_tensor(a) for a in (theta, res, cuts))
    b = B // n
    th, rs, gate = tk._split_gate([t[i * b:(i + 1) * b] for i in range(n)],
                                  [r[i * b:(i + 1) * b] for i in range(n)],
                                  c, n_wanted, torch.device("cpu"))
    assert torch.equal(th, t) and torch.equal(rs, r)
    assert float(gate) == ref
    per_slice = max(float(tk._sweep_gate_maxres(
        t[i * b:(i + 1) * b], r[i * b:(i + 1) * b], c[i * b:(i + 1) * b],
        n_wanted)) for i in range(n))
    if case == "one_slice_unwanted":
        assert per_slice != ref        # the max of the slices' gates is off


def test_mesh_shapes_and_budget(monkeypatch):
    """``design_mesh``: repeats kept, a bare "cpu" as it is, mixed types
    refused, and no mesh by default where no CUDA device is visible. The
    sweep's memory budget is per device: two slices of one card share it,
    two cards hold twice one card's designs."""
    m = design_mesh(["cpu"] * 3)
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3
    assert m.ranges(6) == [(torch.device("cpu"), 0, 2),
                           (torch.device("cpu"), 2, 4),
                           (torch.device("cpu"), 4, 6)]
    with pytest.raises(ValueError):
        m.ranges(4)
    with pytest.raises(ValueError):
        design_mesh(["cpu", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        design_mesh()
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (80 * 2**30, 80 * 2**30))
    dev = torch.device("cuda", 0)
    alone = tv._designs_per_sweep(dev, 40960, 73728, 66)
    one_card = tv._designs_per_sweep(dev, 40960, 73728, 66,
                                     design_mesh(["cuda:0"] * 2))
    two_cards = tv._designs_per_sweep(dev, 40960, 73728, 66,
                                      design_mesh(["cuda:0", "cuda:1"]))
    assert alone > 1
    assert one_card == 2 * (alone // 2) and two_cards == 2 * alone


@pytest.mark.parametrize("device,count,size", [
    ("cuda", 2, 2), ("cuda", 1, None), ("cuda:1", 2, None), ("cpu", 2, None)])
def test_engine_splits_over_visible_cards(monkeypatch, device, count, size):
    """The dataset engine's bucket sweeps and CMT slice sweeps get a mesh
    over every visible CUDA device when the config names a bare "cuda"
    and more than one is visible, else none (``torch.cuda.device_count``
    patched; the sweeps spied, returning no modes)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    meshes = []

    def spy(geoms, grid, n_modes_target=20, config=None, mesh=None, **kw):
        meshes.append(mesh)
        return [[] for _ in geoms]

    monkeypatch.setattr(TrueVectorialMaxwellSolver, "solve_sweep",
                        staticmethod(spy))
    cfg = dataclasses.replace(_cfg(), solver=dataclasses.replace(
        _cfg().solver, device=device))
    gen = tgen.DatasetGenerator(config=cfg, n_taper_slices=3, base_seed=42)
    samples = gen.sampler.generate_stratified_samples(4)
    recs = gen.simulate_bucketed(samples)
    n_bucket = len(meshes)
    assert n_bucket >= 1 and len(recs) == 4
    for sample in samples:
        rec = gen._init_record(sample)
        valid = gen._validate(rec, sample)
        if valid is not None:
            break
    gen._run_cmt(rec, valid[0], [{}] * 2, rec.wavelength_nm,
                 tgen.PhaseTimer())
    assert len(meshes) == n_bucket + 1
    for m in meshes:
        if size is None:
            assert m is None
        else:
            assert m.size == size and m.devices == (
                torch.device("cuda", 0), torch.device("cuda", 1))
