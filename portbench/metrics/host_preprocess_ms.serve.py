"""The host's preprocessing of a fitted classifier's request: validation
and encoding, the members' transforms of the test rows, and the padding
and stacking of each group's arrays (the program's ``mmpfn.preprocess.*``
spans, their union within the request's dispatch)."""

from portbench.metrics.program import preprocess_ms as read  # noqa: F401
