"""The host's lead of a fitted classifier's request: validation, the
members' preprocessing and the uploads before the card gets work."""

from portbench.metrics.served import host_lead_ms as read  # noqa: F401
