"""Design-parallel solving: the sweep's design axis split over devices."""
from .engine import DesignMesh, design_mesh

__all__ = ["design_mesh", "DesignMesh"]
