"""Grid-search studies (Optuna-GridSampler replacement).

The reference drives experiments with `optuna.create_study(GridSampler)`
(`mmpfn/run.py:170-201`); the only sampler it uses is an exhaustive grid, so
this module is a small, dependency-free study object with the same ergonomics
(trials, pruned-trial support, best_trial, JSON and chart output): a copy of
the JAX package's `multimodalpfn_tpu/hpo/study.py`, which needs no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from itertools import product
from typing import Any, Callable, Literal


class TrialPruned(Exception):
    """Raise inside an objective to skip a grid cell (reference `run.py:34-35`
    raises optuna.TrialPruned for mgm_heads < cap_heads)."""


@dataclass
class Trial:
    number: int
    params: dict[str, Any]
    value: float | None = None
    state: Literal["running", "complete", "pruned", "failed"] = "running"
    user_attrs: dict[str, Any] = field(default_factory=dict)
    duration_s: float = 0.0

    def suggest_categorical(self, name: str, choices):
        assert name in self.params, f"{name} not in grid"
        assert self.params[name] in list(choices), (
            f"grid value {self.params[name]} for {name} not in {choices}"
        )
        return self.params[name]

    # int/float suggestions degrade to the grid value too
    suggest_int = suggest_categorical
    suggest_float = suggest_categorical

    def set_user_attr(self, key: str, value: Any) -> None:
        self.user_attrs[key] = value


@dataclass
class GridStudy:
    search_space: dict[str, list]
    direction: Literal["maximize", "minimize"] = "maximize"
    trials: list[Trial] = field(default_factory=list)

    def _grid(self) -> list[dict[str, Any]]:
        keys = list(self.search_space)
        return [dict(zip(keys, vals)) for vals in product(*self.search_space.values())]

    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int | None = None,
        catch: tuple[type[Exception], ...] = (),
    ) -> None:
        cells = self._grid()
        if n_trials is not None:
            cells = cells[:n_trials]
        for params in cells:
            trial = Trial(number=len(self.trials), params=dict(params))
            self.trials.append(trial)
            t0 = time.time()
            try:
                value = objective(trial)
                trial.value = float(value)
                trial.state = "complete"
            except TrialPruned:
                trial.state = "pruned"
            except catch as e:  # noqa: PERF203
                trial.state = "failed"
                trial.user_attrs["error"] = repr(e)
            trial.duration_s = time.time() - t0

    @property
    def completed_trials(self) -> list[Trial]:
        return [t for t in self.trials if t.state == "complete"]

    @property
    def best_trial(self) -> Trial:
        done = self.completed_trials
        if not done:
            raise ValueError("No completed trials.")
        key = (lambda t: t.value) if self.direction == "maximize" else (lambda t: -t.value)
        return max(done, key=key)

    @property
    def best_params(self) -> dict[str, Any]:
        return self.best_trial.params

    @property
    def best_value(self) -> float:
        return self.best_trial.value  # type: ignore[return-value]

    def results_table(self) -> list[dict[str, Any]]:
        return [
            {
                "number": t.number,
                **t.params,
                "value": t.value,
                "state": t.state,
                **t.user_attrs,
                "duration_s": round(t.duration_s, 2),
            }
            for t in self.trials
        ]

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "direction": self.direction,
                    "search_space": {k: list(v) for k, v in self.search_space.items()},
                    "trials": [dataclasses.asdict(t) for t in self.trials],
                },
                f,
                indent=2,
                default=str,
            )


    # --- result collation (replaces the reference's hand-collated
    # charts/*.csv + draw_charts.ipynb pipeline) -----------------------------

    def to_csv(self, path, *, scale: float = 1.0) -> None:
        """Write the reference chart format: tab-separated
        ``mgm_heads  cap_heads  mean  std`` per completed cell
        (`mmpfn/charts/pad_ufes_20.csv`). ``scale=100`` for percentages."""
        with open(path, "w") as f:
            f.write("mgm_heads\tcap_heads\tmean\tstd\n")
            for t in self.completed_trials:
                mean = round((t.value or 0.0) * scale, 2)
                std = round(t.user_attrs.get("std_accuracy", 0.0) * scale, 2)
                f.write(
                    f"{t.params.get('mgm_heads')}\t{t.params.get('cap_heads')}"
                    f"\t{mean}\t{std}\n"
                )

    def summary_table(self, *, scale: float = 1.0) -> str:
        """Human-readable mgm × cap grid of ``mean±std`` (the draw_charts
        heatmap as text), with the best cell marked ``*``."""
        mgms = sorted({t.params.get("mgm_heads") for t in self.trials})
        caps = sorted({t.params.get("cap_heads") for t in self.trials})
        cells = {
            (t.params.get("mgm_heads"), t.params.get("cap_heads")): t
            for t in self.trials
        }
        try:
            best = self.best_trial
        except ValueError:
            best = None
        width = 14
        lines = [
            "mgm\\cap".ljust(8)
            + "".join(str(c).rjust(width) for c in caps)
        ]
        for m in mgms:
            row = [str(m).ljust(8)]
            for c in caps:
                t = cells.get((m, c))
                if t is None or t.state == "pruned":
                    row.append("-".rjust(width))
                elif t.state != "complete":
                    row.append(t.state.rjust(width))
                else:
                    mark = "*" if best is not None and t is best else ""
                    std = t.user_attrs.get("std_accuracy", 0.0) * scale
                    row.append(
                        f"{t.value * scale:.2f}±{std:.2f}{mark}".rjust(width)
                    )
            lines.append("".join(row))
        return "\n".join(lines)


def create_study(
    *, search_space: dict[str, list], direction: str = "maximize"
) -> GridStudy:
    return GridStudy(search_space=search_space, direction=direction)  # type: ignore[arg-type]
