"""Device ms a serve unit of the program's twelve hand-written kernels."""

from portbench.readings import kernel_ms as read  # noqa: F401
