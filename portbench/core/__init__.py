"""The harness: cell resolution, the closed loop, the trace's reduction
and the comparison that decides ``correct``."""
