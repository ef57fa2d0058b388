"""The host's preprocessing of a cached stream's request, which lies in its
dispatch: validation and encoding, the members' transforms of the test
rows, and the padding and stacking of each cache group's arrays."""

from portbench.metrics.program import preprocess_ms as read  # noqa: F401
