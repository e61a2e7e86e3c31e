"""Utilities: phase timing and device traces."""
from .profiling import PhaseTimer, device_trace

__all__ = ["PhaseTimer", "device_trace"]
