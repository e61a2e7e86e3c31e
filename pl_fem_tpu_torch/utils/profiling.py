"""Phase timers, profiler spans and device traces.

The reference's observability is wall-clock fields in each record and
per-module loggers (SURVEY.md §5). This module provides the structured
equivalent: a PhaseTimer that accumulates named phase durations (fed
into DatasetRecord timing fields and DEBUG logs) and opens a ``span``
over each phase, and ``device_trace``, a ``torch.profiler`` trace of a
block of work (viewable in Perfetto or TensorBoard).
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict

try:
    # both private; checked on torch 2.13 (CPU) and 2.11 (CUDA 12.8, H100)
    from torch._C._autograd import _profiler_enabled
    from torch._C._profiler import _RecordFunctionFast as _HostRange
except ImportError:     # another torch: no spans rather than annotations
    _HostRange = _profiler_enabled = None

logger = logging.getLogger("pl_fem_tpu_torch.profiling")

SPAN_PREFIX = "pl_fem."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host range ``pl_fem.<name>`` over the enclosed block while a
    ``torch.profiler`` records this thread, on the profiler's clock (it
    lands in ``prof.events()`` beside the kernel, copy and set records);
    no range, for one flag read, otherwise.

    The range is torch's ``_RecordFunctionFast``, a plain operator
    event: unlike ``record_function`` it is no user annotation, so under
    CUDA tracing kineto puts no device-side copy of it in the trace, and
    the device's busy time stays the kernels', copies' and sets'. Where
    either private API is missing there is no span at all."""
    if _HostRange is None or not _profiler_enabled():
        return _NO_SPAN
    return _HostRange(SPAN_PREFIX + name)


class PhaseTimer:
    """Accumulate named wall-clock phases; each phase is also a
    ``span`` of its name.

    >>> t = PhaseTimer()
    >>> with t.phase("mesh"):
    ...     build_mesh()
    >>> t.times["mesh"]
    """

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            logger.debug("phase %-12s %.3f s", name, dt)

    @property
    def total(self) -> float:
        return sum(self.times.values())

    def summary(self) -> str:
        return " | ".join(f"{k}={v:.2f}s" for k, v in self.times.items())


@contextlib.contextmanager
def device_trace(log_dir):
    """Trace the enclosed block with ``torch.profiler`` (host activity,
    and the CUDA kernels where a CUDA device is present) and write it as
    a Chrome trace (``*.pt.trace.json``) under ``log_dir``. Yields the
    profiler. A long process can lose part of the device records
    (torch.profiler's buffers), so trace device times in a fresh one."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) \
            as prof:
        yield prof
    logger.info("device trace written to %s", log_dir)
