"""Points at which the program's serve entry blocks the host on the device,
a serve call: the program's ``host_syncs.<site>`` counters (the blocking
input copies to the card, the category reads) over its serve calls, read
once the run has ended."""

from portbench.program_trace import host_syncs as read  # noqa: F401
