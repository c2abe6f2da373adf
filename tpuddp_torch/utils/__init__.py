"""Shared helpers of the port — the counterpart of ``tpuddp/utils``."""
