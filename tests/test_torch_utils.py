"""The port's tooling (`multimodalpfn_tpu_torch/utils/`) on the CPU: the
profiling helpers and logging setup against the JAX package's, and the
flat-schema YAML reader against ``yaml.safe_load``.

* `PhaseTimer` accumulates, counts and reports as the JAX one does;
  `trace` writes a Chrome trace; `compiled_cost` of a matmul counts the
  JAX ``compiled_cost`` FLOPs (2·m·n·k); `live_device_memory` is empty
  without a card.
* `setup_logging` writes the JAX setup's lines to its file and, unlike the
  JAX setup's ``dictConfig``, leaves every other handler of the process
  open.
* `utils/flat_yaml` returns ``yaml.safe_load``'s value on every file of
  ``configs/`` and on a document with every scalar form of the schema, and
  refuses each construct outside the schema.
"""

import io
import json
import logging
import logging.config
import re
import time
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
import yaml

from multimodalpfn_tpu_torch.utils import flat_yaml, profiling
from multimodalpfn_tpu_torch.utils.logging import setup_logging

REPO = Path(__file__).resolve().parents[1]
PACKAGE_LOGGERS = ("multimodalpfn_tpu_torch", "multimodalpfn_tpu")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the test: the suite runs six workers on the
    machine's cores, and these small CPU tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def restore_package_loggers():
    """The packages' loggers as they were before the test: a handler a
    setup added (its stream may be the test's captured output) is removed
    and closed after it."""
    saved = {name: (list(lg.handlers), lg.level, lg.propagate)
             for name, lg in ((n, logging.getLogger(n)) for n in PACKAGE_LOGGERS)}
    yield
    for name, (handlers, level, propagate) in saved.items():
        logger = logging.getLogger(name)
        for handler in [h for h in logger.handlers if h not in handlers]:
            logger.removeHandler(handler)
            handler.close()
        logger.handlers[:] = handlers
        logger.setLevel(level)
        logger.propagate = propagate


def no_handler_shutdown(monkeypatch):
    """Keep ``logging.config.dictConfig`` (the JAX package's setup) from
    closing every handler of the test process, the test runner's capture
    among them."""
    monkeypatch.setattr(logging.config, "_clearExistingHandlers", lambda: None)


# ---- profiling -------------------------------------------------------------------


def test_phase_timer_reports_counts_and_means(caplog):
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase("b"):
            time.sleep(0.01)
    with timer.phase("a"):
        pass
    rep = timer.report()
    assert list(rep) == ["a", "b"]
    assert rep["b"]["count"] == 3 and rep["a"]["count"] == 1
    assert rep["b"]["total_s"] >= 0.03
    assert rep["b"]["mean_ms"] == round(timer.totals["b"] / 3 * 1e3, 2) >= 10.0
    with caplog.at_level(logging.INFO, logger=profiling.__name__):
        timer.log()
    assert json.loads(caplog.records[-1].getMessage().split("phase timings: ", 1)[1]) == rep


def test_phase_timer_counts_a_failing_phase_and_matches_jax_keys():
    from multimodalpfn_tpu.utils.profiling import PhaseTimer as JPhaseTimer

    timers = (profiling.PhaseTimer(device="cpu"), JPhaseTimer(sync=False))
    for timer in timers:
        with pytest.raises(ValueError):
            with timer.phase("boom"):
                raise ValueError
    got, want = (t.report() for t in timers)
    assert got.keys() == want.keys() and got["boom"].keys() == want["boom"].keys()
    assert got["boom"]["count"] == want["boom"]["count"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    a, b = torch.ones(32, 16), torch.ones(16, 8)
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        torch.matmul(a, b)
    assert log_dir == str(tmp_path / "trace")
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (33, 7, 12)])
def test_compiled_cost_counts_the_jax_flops(m, k, n):
    from multimodalpfn_tpu.utils.profiling import compiled_cost as jax_cost

    got = profiling.compiled_cost(torch.matmul, torch.ones(m, k), torch.ones(k, n))
    want = jax_cost(lambda a, b: a @ b, jnp.ones((m, k)), jnp.ones((k, n)))
    assert got["flops"] == want["flops"] == 2.0 * m * n * k
    assert got["bytes_accessed"] == -1.0


def test_live_device_memory_is_empty_without_a_card():
    if torch.cuda.is_available():
        assert set(profiling.live_device_memory()) == {f"cuda:{i}" for i in range(torch.cuda.device_count())}
    else:
        assert profiling.live_device_memory() == {}


# ---- logging ---------------------------------------------------------------------


def test_setup_logging_writes_the_jax_lines(tmp_path, monkeypatch):
    from multimodalpfn_tpu.utils.logging import setup_logging as jax_setup

    no_handler_shutdown(monkeypatch)
    lines = {}
    for tag, setup, name in (("torch", setup_logging, "multimodalpfn_tpu_torch"),
                             ("jax", jax_setup, "multimodalpfn_tpu")):
        path = tmp_path / tag / "logs" / "finetune_mmpfn.log"
        logger = setup(log_file=path, level=logging.DEBUG)
        assert logger.name == name and not logger.propagate
        logging.getLogger(f"{name}.train").info("step %d", 3)
        logging.getLogger(f"{name}.train").debug("detail")
        for h in logger.handlers:
            h.flush()
        lines[tag] = [re.sub(r"^\S+ \S+ ", "", ln).replace(name, "PKG")
                      for ln in path.read_text().splitlines()]
    assert lines["torch"] == lines["jax"] == ["[INFO] PKG.train: step 3", "[DEBUG] PKG.train: detail"]


def test_setup_logging_without_a_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    logger = setup_logging(log_file=None)
    assert [type(h).__name__ for h in logger.handlers] == ["StreamHandler"]
    assert not (tmp_path / "logs").exists()


def test_setup_logging_touches_its_logger_alone(tmp_path):
    other, stream = logging.getLogger("another.library"), io.StringIO()
    handler = logging.StreamHandler(stream)
    other.addHandler(handler)
    try:
        setup_logging(log_file=tmp_path / "a.log")
        logger = setup_logging(log_file=tmp_path / "b.log")  # a second call replaces the handlers
        assert [type(h).__name__ for h in logger.handlers] == ["StreamHandler", "FileHandler"]
        other.warning("still open")
        assert not stream.closed and stream.getvalue() == "still open\n"
    finally:
        other.removeHandler(handler)


# ---- the flat YAML reader --------------------------------------------------------


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.yaml")), ids=lambda p: p.name)
def test_flat_yaml_equals_safe_load_on_the_configs(path):
    got = flat_yaml.load(path)
    assert got == yaml.safe_load(path.read_text())
    assert [type(v) for v in got.values()] == [type(v) for v in yaml.safe_load(path.read_text()).values()]


SCALARS = """\
# every scalar form of the schema
int: 42
neg: -7
plus: +3
under: 1_000
zero: 0
float: 0.00001
dot: 1.
lead: .5
exp: 2.5e-3
exp_no_dot: 1e-5
inf: .inf
ninf: -.Inf
bool: yes
switch: Off
true_: true
null_: ~
empty:
word: MGM+CAP  # trailing comment
hash: b#c
single: 'it''s # not a comment'
double: "tab\\tand \\u00e9"
flow: [2, 4.5, "x, y", 'z', yes, ~, MoE]
none_list: []
"""


def test_flat_yaml_equals_safe_load_on_every_scalar_form():
    got, want = flat_yaml.loads(SCALARS), yaml.safe_load(SCALARS)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    assert [type(v) for v in got["flow"]] == [type(v) for v in want["flow"]]
    assert flat_yaml.loads("# nothing\n\n") is yaml.safe_load("# nothing\n\n") is None


OUTSIDE = {
    "nested mapping": "a:\n  b: 1\n",
    "block list": "a:\n- 1\n",
    "flow mapping": "a: {b: 1}\n",
    "anchor": "a: &x 1\n",
    "alias": "a: *x\n",
    "tag": "a: !!str 1\n",
    "block scalar": "a: |\n  x\n",
    "document marker": "---\na: 1\n",
    "duplicate key": "a: 1\na: 2\n",
    "a key YAML reads as a boolean": "on: 1\n",
    "tab": "a:\t1\n",
    "octal": "a: 012\n",
    "hex": "a: 0x1f\n",
    "sexagesimal": "a: 1:30\n",
    "nested list": "a: [1, [2]]\n",
    "unterminated list": "a: [1, 2\n",
    "mapping in a value": "a: b: c\n",
    "text after a quoted value": "a: 'x' y\n",
    "no space after the colon": "a:b\n",
    "indented key": " a: 1\n",
}


@pytest.mark.parametrize("case", list(OUTSIDE))
def test_flat_yaml_refuses_what_lies_outside_the_schema(case, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(OUTSIDE[case])
    with pytest.raises(ValueError, match=r"line \d+"):
        flat_yaml.load(path)


def test_experiment_config_reader_is_the_flat_reader(tmp_path):
    from multimodalpfn_tpu_torch.hpo.experiment import load_experiment_config

    path = REPO / "configs" / "finetuning_hps.yaml"
    assert load_experiment_config(path) == yaml.safe_load(path.read_text())
    (tmp_path / "bad.yaml").write_text(OUTSIDE["nested mapping"])
    with pytest.raises(ValueError, match="outside the flat schema"):
        load_experiment_config(tmp_path / "bad.yaml")
