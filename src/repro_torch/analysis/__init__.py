"""Launch checks for the port's kernels (``launch_check``)."""
from .launch_check import (LAUNCH_RULES, KernelConfigError, Violation,
                           check_incrs_config, check_launch,
                           check_matched_config, require_feasible)

__all__ = ["LAUNCH_RULES", "KernelConfigError", "Violation",
           "check_incrs_config", "check_launch", "check_matched_config",
           "require_feasible"]
