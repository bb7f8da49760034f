"""The whole train unit's share of the float32 peak, in percent: the
configuration's operation count of a unit (a train step three times the
forward) times the units, over the profiled span's seconds and 67
TFLOP/s."""

from portbench.readings import mfu as read  # noqa: F401
