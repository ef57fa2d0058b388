"""The host syncs of a fine-tune iteration: the card's copies that the
host waits for (index uploads, the optimizer's checks, the loop's reads,
the validation's fetch) over the traced iterations."""

from portbench.metrics.program import syncs_per_iteration as read  # noqa: F401
