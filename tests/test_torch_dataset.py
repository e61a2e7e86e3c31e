"""Port parity, dataset engine and CLI: samplers, buckets, records and a
whole 2-sample sweep-engine run with CMT through both packages, and the
checkpoint each package leaves resumed by the other.

Both packages draw the start subspace of every sweep from
``jax.random.PRNGKey(11)`` here: the JAX package does so itself
(pl_fem_tpu/solvers/vectorial.py:686), and the tests hand the same
numbers to the port's ``solve_sweep`` as ``X0`` (as
tests/test_torch_solver.py does). The JAX package's fast mode sends the
subspace to the host in f16 by default, a transfer workaround the port
does not copy; the run here sets its ``xfer_dtype`` to float32 so the two
packages compute the same thing.
"""
import csv
import dataclasses
import json
import shutil
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_fem_tpu.config import MeshConfig as JMeshConfig
from pl_fem_tpu.config import SimulationConfig as JSimulationConfig
from pl_fem_tpu.config import SolverConfig as JSolverConfig
from pl_fem_tpu.config import solver_preset as j_preset
from pl_fem_tpu.dataset import bucketing as jbk
from pl_fem_tpu.dataset import generator as jgen
from pl_fem_tpu.dataset import record as jrec
from pl_fem_tpu.dataset import sampling as jsm
from pl_fem_tpu.dataset.parametric_space import ParametricSpace as JSpace
from pl_fem_tpu.solvers import TrueVectorialMaxwellSolver as JSolver
from pl_fem_tpu_torch import cli
from pl_fem_tpu_torch.config import (MeshConfig, SimulationConfig,
                                     load_config_file, solver_preset)
from pl_fem_tpu_torch.dataset import bucketing as tbk
from pl_fem_tpu_torch.dataset import generator as tgen
from pl_fem_tpu_torch.dataset import record as trec
from pl_fem_tpu_torch.dataset import sampling as tsm
from pl_fem_tpu_torch.dataset.parametric_space import ParametricSpace
from pl_fem_tpu_torch.ops import cuda_kernels as ck
from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver
from pl_fem_tpu_torch.solvers import vectorial as tv

torch.set_num_threads(1)

N_SAMPLES = 2
SEED = 42
NEFF_RTOL = 1e-5     # n_eff and beta, relative
DB_ATOL = 5e-4       # loss metrics (dB, dB/m, indices); measured 4.1e-5
CMT_ATOL = 1e-9      # IL_CMT (dB) and power conservation; measured 1.6e-11
SOLVER_KW = dict(cheb_degree=50, cheb_passes=2, beta_passes=1,
                 bootstrap=False, extra_vectors=4, scalar_tol=1e-4)
SIM_KW = dict(mesh_min_points=500, mesh_target_points=2000,
              n_modes_target=4, cmt_min_scale=0.7)
MESH_KW = dict(bucket_rounding=256, refinement=0.35)


def _same(a, b):
    """Deep equality of plain values, numpy arrays and dataclasses."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if dataclasses.is_dataclass(a):
        return _same(dataclasses.asdict(a), dataclasses.asdict(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


def _geom_same(a, b):
    return _same(vars(a), vars(b))


def _groups(groups):
    return {dataclasses.astuple(k): v for k, v in groups.items()}


# ---------------------------------------------------------------------------
# host layer: samplers, buckets, records
# ---------------------------------------------------------------------------

def test_samplers_equal():
    """SmartSampler (stratified LHS, focused) and AdaptiveSampler give
    the JAX package's samples for one seed, bit for bit."""
    js = jsm.SmartSampler(JSpace(), base_seed=SEED)
    ts = tsm.SmartSampler(ParametricSpace(), base_seed=SEED)
    a = js.generate_stratified_samples(14)
    b = ts.generate_stratified_samples(14)
    assert len(a) >= 10 and _same(a, b)
    assert _same(js.generate_focused_samples(a[3], 4),
                 ts.generate_focused_samples(b[3], 4))
    ja = jsm.AdaptiveSampler(JSpace(n_cores_options=[3, 7]), base_seed=5)
    ta = tsm.AdaptiveSampler(ParametricSpace(n_cores_options=[3, 7]),
                             base_seed=5)
    first = ja.base_sampler.generate_stratified_samples(6)
    assert _same(first, ta.base_sampler.generate_stratified_samples(6))
    oks = [i % 2 == 0 for i in range(len(first))]
    metrics = [{"IL_dB": 1.0 + i} for i in range(len(first))]
    ja.update_from_results(first, oks, metrics)
    ta.update_from_results(first, oks, metrics)
    assert _same(ja.generate_adaptive_samples(6),
                 ta.generate_adaptive_samples(6))
    assert _same(ja.get_convergence_metrics(), ta.get_convergence_metrics())


def test_buckets_equal():
    """bucket_key, class_geometry, canonicalize, group_by_bucket and
    rescale_modes over the geometries of a 14-sample LHS."""
    samples = tsm.SmartSampler(ParametricSpace(), base_seed=SEED) \
        .generate_stratified_samples(14)
    jg = jgen.DatasetGenerator(out_dir=None)
    tg = tgen.DatasetGenerator(out_dir=None)
    jgeoms = [jg.build_geometry(s) for s in samples]
    tgeoms = [tg.build_geometry(s) for s in samples]
    for band in (0.05, 0.20):
        assert _same(_groups(jbk.group_by_bucket(jgeoms, band)),
                     _groups(tbk.group_by_bucket(tgeoms, band)))
        for a, b in zip(jgeoms, tgeoms):
            assert _geom_same(a, b)
            ka, kb = jbk.bucket_key(a, band), tbk.bucket_key(b, band)
            assert _same(ka, kb)
            ca = jbk.class_geometry(ka, a, band)
            cb = tbk.class_geometry(kb, b, band)
            assert _geom_same(ca, cb)
            (ga, sa), (gb, sb) = jbk.canonicalize(a, ca), \
                tbk.canonicalize(b, cb)
            assert sa == sb and _geom_same(ga, gb)
    rng = np.random.default_rng(1)
    modes = [{"n_eff": 1.4 + 0.01 * rng.random(), "beta": 0.0,
              "beta_im": 1e-6 * rng.random()} for _ in range(5)]
    ra = jbk.rescale_modes([dict(m) for m in modes], 0.7, 4.1)
    rb = tbk.rescale_modes([dict(m) for m in modes], 0.7, 4.1)
    assert _same(ra, rb)


def _records(mod):
    """Two success records and one failure, filled the same way."""
    out = []
    for i, il in enumerate((0.8, 12.0, None)):
        r = mod.DatasetRecord(sample_id=f"S{i}", n_cores=3 + i,
                              timestamp="2026-01-01T00:00:00+00:00")
        r.success = il is not None
        r.IL_phys_mux_dB = il
        r.MDL_phys_mux_dB = None if il is None else 0.3 * (i + 1)
        r.PDL_mux_dB = None if il is None else 1.5
        r.crosstalk_mux_dB = -30.0 + i
        r.n_peripheral_cores = None if i == 2 else 6
        r.warnings = [f"w{i}"]
        r.performance_index = r.calculate_performance_index()
        out.append(r)
    return out


def test_records_csv_and_filter_equal(tmp_path):
    """DatasetRecord round trip, CSV rows, performance index and
    physical_filter; the port's csv-module CSV holds the values of the
    JAX package's pandas CSV."""
    ja, ta = _records(jrec), _records(trec)
    for a, b in zip(ja, ta):
        assert _same(a.to_dict(include_modes=True),
                     b.to_dict(include_modes=True))
        assert _same(a.to_csv_row(), b.to_csv_row())
        back = trec.DatasetRecord.from_dict(json.loads(json.dumps(
            a.to_dict())))
        assert _same(back.to_dict(), b.to_dict())
    assert [r.sample_id for r in jgen.DatasetGenerator.physical_filter(ja)] \
        == [r.sample_id for r in tgen.DatasetGenerator.physical_filter(ta)] \
        == ["S0"]
    jgen.DatasetGenerator.write_csv(ja, tmp_path / "j.csv")
    tgen.DatasetGenerator.write_csv(ta, tmp_path / "t.csv")

    def rows(p):
        with open(p, newline="") as f:
            return list(csv.DictReader(f))

    def val(x):
        try:
            return float(x)
        except ValueError:
            return x

    rj, rt = rows(tmp_path / "j.csv"), rows(tmp_path / "t.csv")
    assert list(rj[0]) == list(rt[0])
    for a, b in zip(rj, rt):
        assert {k: val(v) for k, v in a.items()} == \
            {k: val(v) for k, v in b.items()}


def test_describe_matches_pandas():
    pd = pytest.importorskip("pandas")
    recs = _records(trec)[:2] + _records(trec)[:1]
    stats = cli.describe_stats(recs)
    df = pd.DataFrame([r.to_csv_row() for r in recs])
    ref = df[list(cli.STAT_COLUMNS)].describe()
    for c in cli.STAT_COLUMNS:
        np.testing.assert_allclose(stats[c], ref[c].to_numpy(), rtol=1e-12)
    assert "MDL_phys_mux_dB" in cli.describe(recs)


def test_provenance_matches_jax():
    """accuracy_class / solver_mode stamps for every tier and band."""
    for name in ("fast", "balanced", "accuracy"):
        for bucketed in (False, True):
            for band in (0.05, 0.20):
                ja = jgen.DatasetGenerator(config=JSimulationConfig(
                    solver=j_preset(name),
                    mesh=JMeshConfig(bucket_ratio_band=band)))
                ta = tgen.DatasetGenerator(config=SimulationConfig(
                    solver=solver_preset(name),
                    mesh=MeshConfig(bucket_ratio_band=band)))
                ra = jrec.DatasetRecord(sample_id="p")
                rb = trec.DatasetRecord(sample_id="p", timestamp=ra.timestamp)
                ja._provenance(ra, None, bucketed)
                ta._provenance(rb, None, bucketed)
                assert _same(ra.to_dict(), rb.to_dict())


def test_scalar_path_raises(tmp_path):
    """The scalar path is ported: it raises only for what every entry
    point raises for, a CUDA device asked for (the default) and absent.
    The dataset engine records that per sample and carries on."""
    gen, args = cli.generator(["--scalar", "--n", "1", "--out",
                               str(tmp_path)])
    assert args.scalar and gen.use_vectorial is False
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pl_fem_tpu_torch.models import MCFGeometry
    from pl_fem_tpu_torch.solvers import ScalarHelmholtzSolver

    geom = MCFGeometry(1, 8.0, 1.5, 1.53, 1.0, wavelength_um=1.55)
    with pytest.raises(RuntimeError, match="CUDA"):
        ScalarHelmholtzSolver(geom, gen.config).solve(None, 4)
    sample = gen.sampler.generate_stratified_samples(1)[0]
    rec = gen.simulate_sample(sample)
    assert not rec.success and "CUDA" in rec.error_msg
    assert rec.solver_mode == "scalar_cascade"


def test_config_file_without_yaml(tmp_path, monkeypatch):
    """--config with no PyYAML installed fails and says why."""
    p = tmp_path / "c.yaml"
    p.write_text("n: 1\n")
    assert load_config_file(p) == {"n": 1}
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        load_config_file(p)
    with pytest.raises(ImportError, match="PyYAML"):
        cli.main(["--config", str(p), "--out", str(tmp_path)])


def test_r5_workload_through_cli_generator(tmp_path):
    """workloads.dataset_argv through cli.generator: the generator that
    cli.run drives at configs/r5_dataset.yaml, 8 samples, 5 CMT slices."""
    from pl_fem_tpu_torch import workloads as wl

    gen, args = cli.generator(wl.dataset_argv(tmp_path))
    assert (args.n, args.seed, args.engine) == (8, 42, "sweep")
    assert (gen.n_taper_slices, gen.base_seed) == (5, 42)
    cfg = gen.config
    assert (cfg.mesh_min_points, cfg.mesh_target_points) == (9000, 18000)
    assert cfg.mesh.bucket_ratio_band == 0.20
    assert (cfg.solver.cheb_degree, cfg.solver.cheb_passes,
            cfg.solver.beta_passes) == (200, 2, 1)
    assert cfg.use_pml and cfg.solver.device == "cuda"
    assert (tmp_path / "run.log").exists()


# ---------------------------------------------------------------------------
# thread safety of the device path (the bucket pipeline runs two sweeps)
# ---------------------------------------------------------------------------

def test_kernel_library_built_once_by_two_threads(monkeypatch, tmp_path):
    """Two threads calling cuda_kernels.lib() at once build and load the
    library once and share it (the build is a counting stand-in; the
    card half is in test_torch_cuda.py)."""
    calls = []
    release = threading.Event()

    def fake_build(verbose=False):
        calls.append(threading.get_ident())
        release.wait(5)          # hold the build while the other thread waits
        return tmp_path / "lib.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(ck, "_LIB", None)
    monkeypatch.setattr(ck, "build", fake_build)
    monkeypatch.setattr(ck, "_stale", lambda path: True)
    monkeypatch.setattr(ck.ctypes, "CDLL", lambda path: FakeLib())
    got = []
    start = threading.Barrier(2)

    def worker():
        start.wait(5)
        got.append(ck.lib())

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    release.set()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert len(got) == 2 and got[0] is got[1]


def test_sweep_memory_budget_shared_by_threads(monkeypatch):
    """Two threads sweeping at once each budget a quarter of the free
    device memory, not half (each sees the same free memory)."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (80 * 2**30, 80 * 2**30))
    dev = torch.device("cuda")
    alone = tv._designs_per_sweep(dev, 40960, 73728, 66)
    inside, done = threading.Event(), threading.Event()

    def other():
        with tv._sweep_running():
            inside.set()
            done.wait(5)

    t = threading.Thread(target=other)
    t.start()
    try:
        assert inside.wait(5)
        with tv._sweep_running(), tv._sweep_running():   # nested: one thread
            shared = tv._designs_per_sweep(dev, 40960, 73728, 66)
    finally:
        done.set()
        t.join(5)
    assert not t.is_alive()
    assert alone > 1 and shared == alone // 2
    assert tv._SWEEP_THREADS == {}
    assert tv._designs_per_sweep(torch.device("cpu"), 1, 1, 1) == 1 << 30


# ---------------------------------------------------------------------------
# the slice end to end: 2 samples, sweep engine, CMT over 3 slices
# ---------------------------------------------------------------------------

def _port_sweep_with_jax_start(orig):
    def solve_sweep(geometries, grid, n_modes_target=20, config=None, **kw):
        k = min(n_modes_target + config.solver.extra_vectors, grid.n_dofs)
        kw["X0"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(11),
            (3 * grid.n_dofs_padded, len(geometries), k), dtype=jnp.float32))
        return orig(geometries, grid, n_modes_target, config, **kw)
    return staticmethod(solve_sweep)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """records.jsonl of the JAX package (DatasetGenerator.generate) and
    of the port (cli.main with a YAML config, CPU device), same run."""
    root = tmp_path_factory.mktemp("slice")
    jdir, tdir = root / "jax", root / "port"
    jcfg = JSimulationConfig(
        **SIM_KW, mesh=JMeshConfig(**MESH_KW),
        solver=JSolverConfig(backend="tpu", xfer_dtype="float32",
                             **SOLVER_KW))
    solver = "".join(f"    {k}: {v}\n" for k, v in SOLVER_KW.items())
    (root / "run.yaml").write_text(
        f"n: {N_SAMPLES}\nseed: {SEED}\nengine: sweep\ncmt_slices: 3\n"
        "simulation:\n"
        + "".join(f"  {k}: {v}\n" for k, v in SIM_KW.items())
        + "  mesh:\n" + "".join(f"    {k}: {v}\n" for k, v in
                                MESH_KW.items())
        + "  solver:\n    device: cpu\n" + solver)
    with pytest.MonkeyPatch.context() as mp:
        # one device: the JAX run must not shard over the test conftest's
        # 8 virtual CPU devices
        mp.setattr(jgen.DatasetGenerator, "_device_mesh",
                   staticmethod(lambda: None))
        jgen.DatasetGenerator(config=jcfg, n_taper_slices=3, base_seed=SEED,
                              out_dir=jdir).generate(N_SAMPLES,
                                                     engine="sweep")
        mp.setattr(TrueVectorialMaxwellSolver, "solve_sweep",
                   _port_sweep_with_jax_start(
                       TrueVectorialMaxwellSolver.solve_sweep))
        assert cli.main(["--config", str(root / "run.yaml"),
                         "--out", str(tdir)]) == 0
    return root, jdir, tdir


def _load(d):
    return {r["sample_id"]: r for r in map(
        json.loads, (d / "records.jsonl").read_text().splitlines())}


def test_slice_records_match_jax(runs):
    """Every record field but the timings: n_eff within 1e-5 relative,
    the loss metrics within 5e-4 dB (measured 4.1e-5), CMT IL and power
    conservation within 1e-9; everything else equal."""
    _, jdir, tdir = runs
    ref, out = _load(jdir), _load(tdir)
    assert len(ref) == N_SAMPLES and ref.keys() == out.keys()
    ok = [r for r in out.values() if r["success"]]
    assert ok and all(r["IL_CMT_mux_dB"] is not None for r in ok)
    assert all(r["solver_mode"] == "bucketed_sweep" for r in ok)
    for sid, r in ref.items():
        o = out[sid]
        assert r.keys() == o.keys()
        for key, a in r.items():
            b = o[key]
            if key in ("timestamp", "solver_time_s"):
                continue
            if isinstance(a, float) and isinstance(b, float):
                if key.startswith(("n_eff", "beta")):
                    tol = NEFF_RTOL * abs(a)
                elif "CMT" in key or key.startswith("power_conservation"):
                    tol = CMT_ATOL
                else:
                    tol = DB_ATOL
                assert abs(a - b) <= tol, (sid, key, a, b)
            else:
                assert a == b, (sid, key, a, b)
    for name in ("dataset_raw.csv", "run.log"):
        assert (tdir / name).exists()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_across_packages(runs, tmp_path, monkeypatch, direction):
    """Each package resumes from the checkpoint the other wrote: all
    samples are already done, so nothing is solved and nothing appended."""
    _, jdir, tdir = runs
    src = jdir if direction == "jax_to_port" else tdir
    shutil.copy(src / "records.jsonl", tmp_path / "records.jsonl")
    before = (tmp_path / "records.jsonl").read_text()

    def no_solve(*a, **k):
        raise AssertionError("a resumed run re-simulated a sample")

    if direction == "jax_to_port":
        monkeypatch.setattr(TrueVectorialMaxwellSolver, "solve_sweep",
                            staticmethod(no_solve))
        gen = tgen.DatasetGenerator(n_taper_slices=3, base_seed=SEED,
                                    out_dir=tmp_path)
    else:
        monkeypatch.setattr(JSolver, "solve_sweep", staticmethod(no_solve))
        gen = jgen.DatasetGenerator(n_taper_slices=3, base_seed=SEED,
                                    out_dir=tmp_path)
    records = gen.generate(N_SAMPLES, engine="sweep")
    assert sorted(r.sample_id for r in records) == sorted(_load(src))
    assert (tmp_path / "records.jsonl").read_text() == before
