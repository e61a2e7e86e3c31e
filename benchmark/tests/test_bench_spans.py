"""The readers of the program's spans (``filter.device_idle_share``,
``rr.passes_per_design``, ``request.unspanned_s_per_design``) on a
synthetic traced window, checked by hand: two traced requests (1 and 2
designs) and an untraced one, host spans, device intervals, and the
device-side copies of a ``pl_fem.filter`` range and of the request
annotation, which count as no busy time."""
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.cell import Window
from benchmark.harness.trace import REQUEST_SPAN, Trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
READERS = ("filter.device_idle_share", "rr.passes_per_design",
           "request.unspanned_s_per_design")

# (name, start us, end us)
HOST = [
    (REQUEST_SPAN, 0, 1000),
    ("pl_fem.host_build", 10, 100),
    ("pl_fem.filter", 100, 600),
    ("pl_fem.rr_pass", 100, 350),
    ("pl_fem.rr_pass", 350, 600),
    ("aten::mm", 120, 130),
    ("pl_fem.polish", 600, 900),
    (REQUEST_SPAN, 2000, 3000),
    ("pl_fem.filter", 2100, 2500),
    ("pl_fem.rr_pass", 2100, 2200),
    ("pl_fem.rr_pass", 2200, 2350),
    ("pl_fem.rr_pass", 2350, 2500),
    ("pl_fem.cascade", 2600, 2950),
]
DEVICE = [
    ("mass_apply_kernel", 150, 250),
    ("mass_apply_kernel", 200, 400),       # overlaps: counted once
    ("Memcpy DtoH", 650, 700),             # outside the filter
    ("_step", 2450, 2550),                 # 50 us inside the filter
    ("pl_fem.filter", 100, 600),           # mirrors: never busy
    ("pl_fem.filter", 2100, 2500),
    (REQUEST_SPAN, 0, 1000),
]


def _event(name, a, b, dev):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=b))


def _window(host=HOST, device=DEVICE):
    prof = SimpleNamespace(events=lambda: (
        [_event(*h, CPU) for h in host] + [_event(*d, CUDA) for d in device]))
    win = Window()
    win.requests = [{"designs": d, "phases": {}} for d in (1, 2, 5)]
    win.trace = Trace(prof, {})
    return win


def _read(name, win):
    return spec.load_module("metrics", name).read(win)


def test_filter_idle_share_by_hand():
    """Filter spans 500 + 400 us; busy inside them 150..400 (two
    overlapping kernels, 250 us) and 2450..2500 (a kernel clipped at
    the span's end, 50 us): 1 - 300 / 900."""
    assert _read("filter.device_idle_share", _window()) == pytest.approx(
        100.0 * (1.0 - 300.0 / 900.0))


def test_mirrored_span_is_no_busy_time():
    """The same window without the device-side copies reads the same;
    counting the copies would read 0% idle."""
    bare = [d for d in DEVICE if not d[0].startswith("pl_fem.")
            and d[0] != REQUEST_SPAN]
    assert _read("filter.device_idle_share", _window(device=bare)) == \
        _read("filter.device_idle_share", _window())


def test_passes_per_design_by_hand():
    """Five pl_fem.rr_pass spans over the three designs of the two
    traced requests (the untraced request's five designs left out)."""
    assert _read("rr.passes_per_design", _window()) == pytest.approx(5 / 3)


def test_unspanned_seconds_by_hand():
    """Request 1: 0..10 and 900..1000 bare (110 us); request 2:
    2000..2100, 2500..2600, 2950..3000 (250 us); over three designs."""
    assert _read("request.unspanned_s_per_design", _window()) == \
        pytest.approx(360e-6 / 3)


@pytest.mark.parametrize("name", READERS)
def test_silent_without_spans(name):
    """A program without spans (the parent of this reader) and an
    untraced window read nothing, and raise nothing."""
    plain = [h for h in HOST if not h[0].startswith("pl_fem.")]
    assert _read(name, _window(host=plain)) is None
    assert _read(name, Window()) is None


@pytest.mark.parametrize("name", READERS)
def test_reported_in_the_scalar_cell(name):
    """Each reader is a per-layer metric of the cell whose spans it
    reads, moving ``designs_per_s``."""
    bench = spec.load_benchmark()
    m = spec.find(bench["per_layer"], name, "metric")
    assert m["source"] == "program_span" and m["moves"] == "designs_per_s"
    cell = spec.Cell(bench, "hex7_scalar_deg600_band")
    assert name in {p["name"] for p in cell.per_layer}
