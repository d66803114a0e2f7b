"""InCRS and CRS formats (host-side numpy)."""
from .crs import CRS
from .incrs import InCRS

__all__ = ["CRS", "InCRS"]
