"""Hand-written Hopper kernels, their plain torch versions, and ``ops``."""
