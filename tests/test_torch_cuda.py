"""The hand-written kernels on the card against their plain twins.

Every test here needs a CUDA device and skips without one; they import
neither jax nor the JAX package, so they also run where only the port
is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance: <= 1e-5 of max|y| (f32 kernel vs f32 twin, two orderings of
the same sums).
"""
import threading

import numpy as np
import pytest
import torch

from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops import assembly as ta
from pl_fem_tpu_torch.ops import cuda_kernels as ck
from pl_fem_tpu_torch.ops import kernels as tk
from pl_fem_tpu_torch.ops import triton_kernels as trk
from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid

pytestmark = pytest.mark.cuda
B, K = 3, 7


def _rel(ref, y):
    ref = ref.double().cpu()
    y = y.double().cpu()
    return float((ref - y).abs().max() / (ref.abs().max() + 1e-300))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA and Triton kernels have "
                    "no CPU mode; their plain twins are tested against the "
                    "JAX package in test_torch_kernels.py)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup(dev):
    cfg = SimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                           mesh=MeshConfig(bucket_rounding=256))
    geoms = [MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=float(w))
             for w in np.linspace(1.50, 1.60, B)]
    dg = export_device_grid(MeshGenerator.generate(geoms[0], 0.5, cfg), 256)
    ga = ta.grid_to_device(dg, dev)
    invs = [ta.assemble_vector3_qf(ga, ta.eps_arrays(g.eps_params(), dev))[0]
            for g in geoms]
    qs = tk.QFactorSweep(invJT=invs[0].invJT, w=invs[0].w,
                         inv_eps=torch.stack([q.inv_eps for q in invs]),
                         gp=ga.grad_phys)
    gen = torch.Generator(device=dev).manual_seed(3)
    D = dg.n_dofs_padded
    X = torch.randn((D, B * 3 * K), generator=gen, device=dev)
    return dict(ga=ga, gs=ta.gather_scatter(ga), qs=qs, X=X, gen=gen,
                betas=torch.tensor([g.k0 * 1.49 for g in geoms], device=dev))


def test_apply_vector3_elem(setup, dev):
    s = setup
    Xm = s["X"] * s["ga"].interior_mask[:, None]
    args = (s["gs"].elem_dofs, s["qs"].gp, s["qs"].w, s["qs"].inv_eps,
            s["betas"], 1.0, tk.shape_table(dev), K)
    n0 = ck.apply_vector3_elem.launches
    y = ck.apply_vector3_elem(Xm, *args)
    assert ck.apply_vector3_elem.launches == n0 + 1
    assert _rel(ck.apply_vector3_elem_plain(Xm, *args), y) <= 1e-5


@pytest.mark.parametrize("epilogue", [False, True])
def test_accumulate(setup, dev, epilogue):
    s = setup
    gs = s["gs"]
    E = gs.elem_dofs.shape[0]
    Ye = torch.randn((E, 6, s["X"].shape[1]), generator=s["gen"], device=dev)
    tables = (gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e)
    extra = ()
    if epilogue:
        park = torch.full((s["X"].shape[1],), 7.0, device=dev)
        extra = (s["X"], s["ga"].interior_mask, park)
    y = ck.accumulate(Ye, *tables, *extra)
    assert _rel(ck.accumulate_plain(Ye, *tables, *extra), y) <= 1e-5
    # deterministic: a second launch gives the same bits
    assert torch.equal(y, ck.accumulate(Ye, *tables, *extra))


def test_mass_diagonal_single_lane(setup, dev):
    """K2 at L = 1, the mass diagonal of assemble_vector3_qf."""
    s = setup
    _, diag = ta.assemble_vector3_qf(
        s["ga"], ta.eps_arrays(MCFGeometry(3, 8.0, 1.5, 1.535, 1.0)
                               .eps_params(), dev))
    ga_cpu = ta.GridArrays(*(t.cpu() for t in s["ga"]))
    _, ref = ta.assemble_vector3_qf(
        ga_cpu, ta.eps_arrays(MCFGeometry(3, 8.0, 1.5, 1.535, 1.0)
                              .eps_params(), "cpu"))
    assert _rel(ref, diag) <= 1e-5


def test_apply_mass_elem(setup, dev):
    s = setup
    Xm = s["X"] * s["ga"].interior_mask[:, None]
    args = (s["gs"].elem_dofs, s["qs"].w, tk.shape_table(dev))
    y = ck.apply_mass_elem(Xm, *args)
    assert _rel(ck.apply_mass_elem_plain(Xm, *args), y) <= 1e-5


@pytest.mark.parametrize("first,renorm", [(True, False), (False, False),
                                          (False, True)])
def test_cheb_step(dev, first, renorm):
    g = torch.Generator(device=dev).manual_seed(1)
    W, V, T0 = (torch.randn((300, B, 3, K), generator=g, device=dev)
                for _ in range(3))
    T0 = None if first else T0
    c = torch.tensor([1.0, 2.0, 3.0], device=dev)
    h = torch.tensor([4.0, 5.0, 6.0], device=dev)
    V1, V2 = V.clone(), V.clone()
    y = trk.cheb_step(W, V1, T0, c, h, renorm=renorm)
    ref = trk.cheb_step_plain(W, V2, T0, c, h, renorm=renorm)
    assert _rel(ref, y) <= 1e-5
    assert _rel(V2, V1) <= 1e-5


def test_filter_on_card_matches_cpu(setup, dev):
    """Twelve filter steps through all four kernels == the same steps
    through the twins on the CPU (1e-4: rounding amplified by the
    Chebyshev growth between renorms)."""
    s = setup
    ga, gs, qs = s["ga"], s["gs"], s["qs"]
    D = ga.interior_mask.shape[0]
    _, diag = ta.assemble_vector3_qf(
        ga, ta.eps_arrays(MCFGeometry(3, 8.0, 1.5, 1.535, 1.0)
                          .eps_params(), dev))
    dinv = 1.0 / torch.sqrt(diag)
    lo, hi = np.float32(tk.MASS_LO), np.float32(tk.MASS_HI)
    vec = {"parks": [400.0] * B, "cuts": [40.0] * B, "bounds": [4e3] * B}
    X = s["X"].reshape(D, B, 3, K)

    def run(d, mv):
        t = {n: torch.tensor(v, device=d) for n, v in mv.items()}
        cast = lambda a: a.to(d)                               # noqa: E731
        return tk.cheb_sweep_filter(
            tk.QFactorSweep(*map(cast, qs)),
            tk.GatherScatter(*map(cast, gs)), cast(ga.interior_mask),
            cast(dinv), lo, hi, t["parks"], cast(s["betas"]), 1.0,
            cast(X), t["cuts"], t["bounds"], degree=12, binv_degree=1)

    counts = [f.launches for f in (ck.apply_vector3_elem, ck.accumulate,
                                   ck.apply_mass_elem, trk.cheb_step)]
    y = run(dev, vec)
    after = [f.launches for f in (ck.apply_vector3_elem, ck.accumulate,
                                  ck.apply_mass_elem, trk.cheb_step)]
    assert all(a > b for a, b in zip(after, counts))
    assert _rel(run("cpu", vec), y) <= 1e-4


def test_wrappers_refuse_bad_input(dev):
    """A CUDA tensor never reaches a twin: input the kernel does not
    take raises."""
    x = torch.zeros((8, 12), device=dev, dtype=torch.float64)
    ed = torch.zeros((2, 6), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        ck.apply_mass_elem(x, ed, torch.zeros((2, 6), device=dev),
                           tk.shape_table(dev))
    with pytest.raises(ValueError):
        ck.apply_mass_elem(x.float().t(), ed, torch.zeros((2, 6), device=dev),
                           tk.shape_table(dev))


# ---------------------------------------------------------------------------
# the dataset engine's shapes: r5 production mesh, B = 1 or 5 designs per
# bucket, k = 20 (3-core) or 66 (19-core) columns
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def r5(dev):
    """A bucket mesh at configs/r5_dataset.yaml's settings (9000-18000
    points, bucket_rounding 4096) and five designs on it."""
    cfg = SimulationConfig(mesh_min_points=9000, mesh_target_points=18000)
    geoms = [MCFGeometry(7, 8.0, 1.5, 1.535, 1.0, wavelength_um=float(w))
             for w in np.linspace(1.53, 1.61, 5)]
    dg = export_device_grid(MeshGenerator.generate(geoms[0], 1.0, cfg),
                            cfg.mesh.bucket_rounding)
    ga = ta.grid_to_device(dg, dev)
    invs = [ta.assemble_vector3_qf(ga, ta.eps_arrays(g.eps_params(), dev))[0]
            for g in geoms]
    return dict(ga=ga, gs=ta.gather_scatter(ga), invs=invs,
                betas=[g.k0 * 1.49 for g in geoms])


@pytest.mark.parametrize("b,k", [(1, 20), (1, 66), (5, 20), (5, 66)])
def test_kernels_at_dataset_shapes(r5, dev, b, k):
    """K1-K4 against their twins at the shapes the dataset engine gives
    them (1e-5 of max|y|)."""
    ga, gs, invs = r5["ga"], r5["gs"], r5["invs"][:b]
    qs = tk.QFactorSweep(invJT=invs[0].invJT, w=invs[0].w,
                         inv_eps=torch.stack([q.inv_eps for q in invs]),
                         gp=ga.grad_phys)
    betas = torch.tensor(r5["betas"][:b], device=dev)
    D = ga.interior_mask.shape[0]
    L = b * 3 * k
    g = torch.Generator(device=dev).manual_seed(b * 100 + k)
    X = torch.randn((D, L), generator=g, device=dev)
    Xm = X * ga.interior_mask[:, None]
    N = tk.shape_table(dev)
    elem = (gs.elem_dofs, qs.gp, qs.w, qs.inv_eps, betas, 1.0, N, k)
    Ye = ck.apply_vector3_elem(Xm, *elem)
    assert _rel(ck.apply_vector3_elem_plain(Xm, *elem), Ye) <= 1e-5
    tables = (gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e)
    park = torch.full((L,), 50.0, device=dev)
    extra = (X, ga.interior_mask, park)
    assert _rel(ck.accumulate_plain(Ye, *tables, *extra),
                ck.accumulate(Ye, *tables, *extra)) <= 1e-5
    mass = (gs.elem_dofs, qs.w, N)
    assert _rel(ck.apply_mass_elem_plain(Xm, *mass),
                ck.apply_mass_elem(Xm, *mass)) <= 1e-5
    W, T1, T0 = (torch.randn((D, b, 3, k), generator=g, device=dev)
                 for _ in range(3))
    c = torch.linspace(100.0, 120.0, b, device=dev)
    h = torch.linspace(900.0, 1000.0, b, device=dev)
    for renorm in (False, True):
        V1, V2 = T1.clone(), T1.clone()
        y = trk.cheb_step(W, V1, T0, c, h, renorm=renorm)
        assert _rel(trk.cheb_step_plain(W, V2, T0, c, h, renorm=renorm),
                    y) <= 1e-5
        assert _rel(V2, V1) <= 1e-5
    torch.cuda.synchronize()


def test_library_built_once_by_two_threads(dev, monkeypatch):
    """Two threads calling lib() at once on a machine with no library
    yet: nvcc runs once, both threads get the same handle, and it
    launches."""
    builds = []
    real_build = ck.build

    def counting_build(verbose=False):
        builds.append(1)
        return real_build(verbose)

    lib_path = ck.BUILD_DIR / ck._LIB_NAME
    if lib_path.exists():
        lib_path.unlink()
    monkeypatch.setattr(ck, "_LIB", None)
    monkeypatch.setattr(ck, "build", counting_build)
    got = []
    start = threading.Barrier(2)

    def worker():
        start.wait(60)
        got.append(ck.lib())

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not any(t.is_alive() for t in threads)
    assert builds == [1] and len(got) == 2 and got[0] is got[1]
    x = torch.randn((64, 6), device=dev)
    ed = torch.randint(0, 64, (8, 6), dtype=torch.int32, device=dev)
    w = torch.rand((8, 6), device=dev)
    N = tk.shape_table(dev)
    assert _rel(ck.apply_mass_elem_plain(x, ed, w, N),
                ck.apply_mass_elem(x, ed, w, N)) <= 1e-5


def test_triton_first_launch_from_two_threads(dev, monkeypatch):
    """K4's first launch (its Triton compile) from two threads at once:
    both results equal the twin's."""
    monkeypatch.setattr(trk, "_KERNELS", {})
    g = torch.Generator(device=dev).manual_seed(9)
    W, V, T0 = (torch.randn((500, 2, 3, 13), generator=g, device=dev)
                for _ in range(3))
    c = torch.tensor([1.0, 2.0], device=dev)
    h = torch.tensor([4.0, 5.0], device=dev)
    ref = trk.cheb_step_plain(W, V.clone(), T0, c, h, renorm=True)
    out = [None, None]
    start = threading.Barrier(2)

    def worker(i):
        start.wait(60)
        out[i] = trk.cheb_step(W, V.clone(), T0, c, h, renorm=True)
        torch.cuda.synchronize()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not any(t.is_alive() for t in threads)
    assert all(_rel(ref, y) <= 1e-5 for y in out)
