"""The cached stream's window's share of the card's bf16 peak: the
operations its cached predicts need over the window's wall time."""

from portbench.metrics.served import mfu as read  # noqa: F401
