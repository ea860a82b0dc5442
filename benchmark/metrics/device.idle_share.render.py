"""device.idle_share.render: the share of the traced sub-window (a few frames
after the window, under torch.profiler) in which no operation ran on the
card (benchmark.trace.idle_share), in percent."""
from benchmark.trace import idle_share as read  # noqa: F401
