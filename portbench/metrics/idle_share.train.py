"""The share of the profiled span of train units in which no operation ran
on the device, in percent: one minus the union of the device intervals
over the span's wall time."""

from portbench.readings import idle_share as read  # noqa: F401
