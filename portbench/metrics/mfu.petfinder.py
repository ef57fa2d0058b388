"""The PetFinder window's share of the card's bf16 peak: the operations its
requests need (`work/forward.request_flops`: two embedding tokens through
MGM+CAP 32/24, two features a group, every member at its width with
preprocessing off) over the window's wall time."""

from portbench.metrics.served import mfu as read  # noqa: F401
