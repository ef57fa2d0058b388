"""The port's process groups and mesh (`parallel/mesh.py`) on the CPU, over
gloo ranks (`parallel/launch.run_ranks`: one spawned process and one torch
thread a rank, a file store under ``tmp_path``).

* `initialize_distributed`'s four cases, each in a subprocess with the
  cluster markers set or cleared by ``monkeypatch``: already initialized ->
  True; explicit kwargs that fail -> raises; no kwargs and no markers ->
  False; markers present and the rendezvous fails -> raises. Asking for the
  card without CUDA raises too.
* Two processes join one group and all-reduce once (the counterpart of the
  JAX package's two-process test, `tests/test_distributed_init.py`).
* `param_shardings` equals the JAX package's ``PartitionSpec``s leaf for
  leaf (the axis carrying ``"mp"``, or None) at mp 1, 2 and 4 on tiny
  MGM+CAP and MoE models; `shard_params` cuts those axes and the shards
  gather back bit for bit.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu.models.params import init_params as jinit_params
from multimodalpfn_tpu.parallel.mesh import make_mesh as jmake_mesh
from multimodalpfn_tpu.parallel.mesh import param_shardings as jparam_shardings
from multimodalpfn_tpu_torch.parallel.launch import run_ranks
from tests import torch_parallel_workers as workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKERS = ("SLURM_NTASKS", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK")

# a case's body runs after `from multimodalpfn_tpu_torch.parallel.mesh import
# initialize_distributed as init` and prints one word
INIT_CASES = {
    "already_initialized": (
        {},
        """
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method="file://" + sys.argv[1] + "/store", world_size=1, rank=0)
        print("TRUE" if init() is True else "WRONG")
        """,
        "TRUE",
    ),
    "explicit_kwargs_fail": (
        {},
        """
        import datetime
        try:  # nothing listens on port 1: rank 1 cannot reach the store
            init(device="cpu", init_method="tcp://127.0.0.1:1", world_size=2, rank=1,
                 timeout=datetime.timedelta(seconds=3))
        except Exception as e:
            print("RAISED", type(e).__name__)
        else:
            print("SWALLOWED")
        """,
        "RAISED",
    ),
    "no_cluster_returns_false": (
        {},
        """
        import torch.distributed as dist
        print("FALSE" if init(device="cpu") is False and not dist.is_initialized() else "WRONG")
        """,
        "FALSE",
    ),
    "markers_and_failed_init_raise": (
        {"SLURM_NTASKS": "2"},  # a two-task job, but no rendezvous address
        """
        try:
            init(device="cpu")
        except Exception as e:
            print("RAISED", type(e).__name__)
        else:
            print("SWALLOWED")
        """,
        "RAISED",
    ),
    "cuda_missing_raises": (
        {"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1"},
        """
        import torch
        try:
            init()
        except RuntimeError as e:
            print("RAISED" if "CUDA is not available" in str(e) and not torch.cuda.is_available() else "WRONG")
        else:
            print("SWALLOWED")
        """,
        "RAISED",
    ),
}


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_initialize_distributed_cases(case, tmp_path, monkeypatch):
    env, body, want = INIT_CASES[case]
    for name in MARKERS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    code = ("import sys\nfrom multimodalpfn_tpu_torch.parallel.mesh import initialize_distributed as init\n"
            + textwrap.dedent(body))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == want, out.stdout + out.stderr


def test_two_process_init_and_all_reduce(tmp_path):
    assert run_ranks(workers.all_reduce_rank, 2, workdir=tmp_path) == [3.0, 3.0]


def _jcfg(mixer_type: str, heads: int) -> JModelConfig:
    # 6 heads and MoE's 3 experts do not divide by 4 (or 2): those leaves stay replicated
    return JModelConfig(emsize=24, nhead=6, nhid_factor=2, nlayers=2, n_out=4, max_num_classes=4,
                        mixer=JMixerConfig(mixer_type, mgm_heads=heads, cap_heads=2, in_dim=48))


MODELS = {"mgm_cap": _jcfg("MGM+CAP", 2), "moe": _jcfg("MoE", 3)}


@pytest.fixture(scope="module")
def trees():
    return {name: jax.device_get(jinit_params(jax.random.PRNGKey(0), cfg, model_seed=0))
            for name, cfg in MODELS.items()}


@pytest.fixture(scope="module")
def port_shardings(trees, tmp_path_factory):
    """The four ranks' results (all ranks must agree)."""
    outs = run_ranks(workers.shardings_and_gathers, 4, trees, workdir=tmp_path_factory.mktemp("ranks"))
    for other in outs[1:]:
        assert other == outs[0]
    return outs[0]


def _jax_axes(tree, mp: int) -> dict:
    shardings = jparam_shardings(tree, jmake_mesh(4, mp=mp))
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    out = {}
    for path, sharding in flat:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        spec = tuple(sharding.spec)
        out[key] = spec.index("mp") if "mp" in spec else None
    return out


@pytest.mark.parametrize("mp", [1, 2, 4])
@pytest.mark.parametrize("model", list(MODELS))
def test_param_shardings_match_jax(model, mp, trees, port_shardings):
    want = _jax_axes(trees[model], mp)
    got = port_shardings[model, mp]
    assert set(got) == set(want)
    assert got == want
    # every case shards something at mp > 1 and replicates something
    if mp > 1:
        assert any(a is not None for a in got.values()) and any(a is None for a in got.values())


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("model", list(MODELS))
def test_shard_params_cut_and_gather_back(model, mp, trees, port_shardings):
    flat = {"/".join(map(str, (getattr(p, "key", p) for p in path))): np.shape(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(trees[model])[0]}
    for key, axis in port_shardings[model, mp].items():
        want = list(flat[key])
        if axis is not None:
            want[axis] //= mp
        assert port_shardings[model, mp, "shard_shapes"][key] == tuple(want), key
    assert port_shardings[model, mp, "gathered"]
