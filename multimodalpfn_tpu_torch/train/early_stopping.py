"""Adaptive-patience early stopping.

Semantics anchor: reference `scripts_finetune_mm/metric_utils/ag_early_stopping.py:9-84`
(AutoGluon AdaptiveES): patience grows with the best round,
``patience = clip(round(best_round * rate) + offset, min, max)``.
Note the reference computes patience but leaves stopping disabled
(`finetune_mmpfn_main.py:433-436,477-478`); callers opt in via ``enabled``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AdaptiveES:
    adaptive_rate: float = 0.2
    adaptive_offset: int = 5
    min_patience: int = 50
    max_patience: int = 100

    best_round: int = field(default=0, init=False)
    current_round: int = field(default=0, init=False)

    def _patience(self) -> int:
        p = round(self.best_round * self.adaptive_rate) + self.adaptive_offset
        return int(min(max(p, self.min_patience), self.max_patience))

    def update(self, *, cur_round: int, is_best: bool = False) -> bool:
        """Record round result; returns True when training should stop."""
        self.current_round = cur_round
        if is_best:
            self.best_round = cur_round
        return self.remaining_patience <= 0

    @property
    def remaining_patience(self) -> int:
        return self._patience() - (self.current_round - self.best_round)
