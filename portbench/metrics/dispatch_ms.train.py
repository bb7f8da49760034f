"""Host ms from the benchmark's call into the program's train entry to its
return, the mean over the measured window's units."""

from portbench.readings import dispatch_ms as read  # noqa: F401
