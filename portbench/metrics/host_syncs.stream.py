"""The host syncs of a cached stream's request: the card's copies that the
host waits for over the traced requests. A sync in a dispatch waits for
the request in flight, so it breaks the pipelining."""

from portbench.metrics.program import syncs_per_request as read  # noqa: F401
