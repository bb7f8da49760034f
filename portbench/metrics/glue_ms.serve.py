"""Device ms a serve unit of the kernels that are neither the program's own
nor matrix products: the model's glue (BatchNorm, elementwise work,
reductions, concatenations), copies and fills left out."""

from portbench.readings import glue_ms as read  # noqa: F401
