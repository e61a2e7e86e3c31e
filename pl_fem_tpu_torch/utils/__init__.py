"""Utilities: phase timing, profiler spans and device traces."""
from .profiling import PhaseTimer, device_trace, span

__all__ = ["PhaseTimer", "device_trace", "span"]
