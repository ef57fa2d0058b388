"""The card's idle time in a fine-tune iteration (the episode's step and
the validation): the untraced window's iteration time less the card's busy
time an iteration of the traced slice, ms."""

from portbench.metrics.program import step_idle_ms as read  # noqa: F401
