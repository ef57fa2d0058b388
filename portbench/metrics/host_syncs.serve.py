"""The host syncs of a fitted classifier's request: the card's copies that
the host waits for (blocking uploads, the fetch) over the traced
requests."""

from portbench.metrics.program import syncs_per_request as read  # noqa: F401
