"""Runtime tooling (profiling, NaN guard, memory snapshot)."""
