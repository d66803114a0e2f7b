"""Serving: the LM wave engine, the SpMM wave scheduler and engine, and
the multi-tenant pool of SpMM engines."""
from .engine import Request, ServeEngine, SpMMEngine, SpMMRequest  # noqa: F401
from .scheduler import (WaveCostModel, WavePacker,  # noqa: F401
                        seed_cost_model)
from .tenancy import TenantPool  # noqa: F401
