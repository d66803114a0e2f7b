"""SpMM serving: wave scheduler and engine."""
