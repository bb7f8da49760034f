"""Host ms the trainer waits on the input pipeline's prefetch iterator
(``next()`` on ``prefetch_to_device``) a step, the mean over the measured
window's steps."""

from portbench.readings import input_wait_ms as read  # noqa: F401
