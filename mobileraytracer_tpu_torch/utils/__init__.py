"""Phase timers and run metrics, render checkpoints, and debug guards."""
from .metrics import PhaseTimer, RunMetrics  # noqa: F401
