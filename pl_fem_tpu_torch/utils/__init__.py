"""Utilities: phase timing."""
from .profiling import PhaseTimer

__all__ = ["PhaseTimer"]
