"""The share of the input pipeline's waits (``next()`` on
``prefetch_to_device``) that found its queue empty, in percent: the
program's ``input_empty`` over its ``input_waits`` counter, read once the
run has ended."""

from portbench.program_trace import input_empty_share as read  # noqa: F401
