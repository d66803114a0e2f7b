"""InCRS, CRS and BSR formats (host-side numpy)."""
from .bsr import BSR, magnitude_block_mask
from .crs import CRS
from .incrs import InCRS

__all__ = ["BSR", "CRS", "InCRS", "magnitude_block_mask"]
