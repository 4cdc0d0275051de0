"""The harness: data loading, the closed-loop window, the trace, the check."""
