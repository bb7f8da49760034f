"""The program's kernels in a train unit against their roofline: the least
time of each launch (bytes at 3.35 TB/s or float32 operations at 67
TFLOP/s, roofline.bound on the unit's recorded inputs) over those
kernels' device time, in percent."""

from portbench.readings import kernel_roofline as read  # noqa: F401
