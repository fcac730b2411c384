"""PyTorch port: data and tensor parallelism (``parallel/``) on the CPU.

- the sharding rules against the JAX ``sharding_pytree``, leaf for leaf,
  on a float and an int8 tree; ``make_mesh``'s validation; ``shard_batch``
  and ``shard_params`` on a stand-in mesh; ``_auto_mesh`` and
  ``load_model(mesh=None)``;
- one spawned 2-process gloo world (``parallel.dryrun.spawn``: a file
  store under the test's directory, one torch thread a process, a timeout
  of its own) that reshapes its mesh once: dp=2 (greedy, int8,
  timestamps, beam search, and a forced sampled fallback rung) and tp=2
  (greedy, timestamps, beam search, the sampled rung), each transcription
  against one process
  (times exact; greedy-decided text exact at f32, and the sampled rung's
  outside a tail batch the mesh pads to more rows), and a train step on
  each mesh against one process's (the loss within 1e-5 relative, the
  moments within 1e-5 of each leaf's largest magnitude, the params within
  1e-6 where the gradient is at least 1e-6; ``dryrun.TRAIN_TOL``).  Each
  check's line is its own test, with its measured values in the report;
- a slow 4-process dp=2 x tp=2 dry run, as the JAX dry run's subprocess
  test.
"""

import json

import numpy as np
import pytest
import torch

from cpu_budget import one_torch_thread  # noqa: F401
from manual_whisper_tpu.models import whisper as jw
from manual_whisper_tpu.ops.quant import quantize_params as jquantize
from manual_whisper_tpu.parallel import make_mesh as jmake_mesh
from manual_whisper_tpu.parallel import sharding_pytree
from manual_whisper_tpu_torch.convert import from_jax_tree
from manual_whisper_tpu_torch.models import whisper as tw
from manual_whisper_tpu_torch.parallel import dryrun, mesh as tm
from manual_whisper_tpu_torch.training.optim import tree_leaves

CPU = torch.device("cpu")
JCFG = jw.MODEL_CONFIGS["test"]
TCFG = tw.MODEL_CONFIGS["test"]
WORLD_TIMEOUT = 300


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_rules_match_jax_leaf_for_leaf(kind):
    tree = jw.init_params_host(0, JCFG)
    if kind == "int8":
        tree = jquantize(tree)
    jspecs = sharding_pytree(tree, jmake_mesh(1))
    port = from_jax_tree(tree, TCFG.with_dtype(torch.bfloat16), CPU)
    specs = tm.resolve_specs(port)

    def walk(j, t, p, path):
        if isinstance(p, dict):
            assert set(p) == set(t), path
            for k in p:
                walk(j[k], t[k], p[k], f"{path}/{k}")
            return
        stacked = "/blocks/" in path
        if stacked:                    # one layer's leaf: drop the L axis
            want = _padded(j.spec, p.ndim + 1)[1:]
        else:
            want = _padded(j.spec, p.ndim)
        assert _padded(t, p.ndim) == want, (path, t, j.spec)

    for part in ("encoder", "decoder"):
        for key in port[part]:
            if key == "blocks":
                for layer, blk in enumerate(port[part]["blocks"]):
                    walk(jspecs[part]["blocks"], specs[part]["blocks"][layer],
                         blk, f"{part}/blocks/{layer}")
            else:
                walk(jspecs[part][key], specs[part][key], port[part][key],
                     f"{part}/{key}")


def test_make_mesh_validation():
    with pytest.raises(ValueError, match="divisible"):
        tm.make_mesh(4, model_parallel=3)
    with pytest.raises(ValueError, match="model_parallel"):
        tm.make_mesh(2, model_parallel=0)
    with pytest.raises(RuntimeError, match="process group"):
        tm.make_mesh()


class _Dim:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


class _StandInMesh:
    """What the port asks of a DeviceMesh, for one rank of a layout."""

    def __init__(self, data, model, data_rank, model_rank):
        self.dims = {"data": data, "model": model}
        self.ranks = {"data": data_rank, "model": model_rank}

    def __getitem__(self, axis):
        return _Dim(self.dims[axis])

    def get_local_rank(self, axis):
        return self.ranks[axis]

    def size(self):
        return self.dims["data"] * self.dims["model"]

    def get_group(self, axis):
        return f"group:{axis}"


@pytest.mark.parametrize("layout, want", [
    ((2, 2), {"data": "group:data", "model": "group:model"}),
    ((2, 1), {"data": "group:data", "model": None}),
    ((1, 2), {"data": None, "model": "group:model"}),
    ((1, 1), {"data": "group:data", "model": "group:model"})])
def test_axis_group_of_each_layout(layout, want):
    """A one-rank axis of a wider world has no group; a one-rank world's
    mesh keeps both, so its collectives run."""
    mesh = _StandInMesh(*layout, data_rank=0, model_rank=0)
    assert {axis: tm.axis_group(mesh, axis) for axis in want} == want


def test_shard_batch_takes_the_ranks_rows():
    mesh = _StandInMesh(2, 2, data_rank=1, model_rank=0)
    x = torch.arange(12).reshape(4, 3)
    mel, temp, arr = tm.shard_batch((x, torch.tensor(0.5),
                                     np.arange(8)), mesh)
    assert torch.equal(mel, x[2:]) and float(temp) == 0.5
    np.testing.assert_array_equal(arr, np.arange(4, 8))
    with pytest.raises(ValueError, match="divisible"):
        tm.shard_batch(torch.zeros(3, 2), mesh)


@pytest.mark.parametrize("int8", [False, True])
def test_shard_params_takes_the_ranks_shards(int8):
    from manual_whisper_tpu_torch.ops.quant import quantize_params
    full = tw.init_params(TCFG, CPU, seed=0)
    if int8:
        full = quantize_params(full)
    local = tm.shard_params(full, _StandInMesh(1, 2, 0, 1))
    assert set(local) == {"encoder", "decoder"}
    blk, fblk = local["decoder"]["blocks"][1], full["decoder"]["blocks"][1]
    if int8:
        assert torch.equal(blk["attn"]["q_w"]["q"],
                           fblk["attn"]["q_w"]["q"][:, 32:])
        assert torch.equal(blk["attn"]["q_w"]["s"],
                           fblk["attn"]["q_w"]["s"][32:])
        assert torch.equal(blk["mlp"]["fc2_w"]["q"],
                           fblk["mlp"]["fc2_w"]["q"][128:])
        assert torch.equal(blk["mlp"]["fc2_w"]["s"], fblk["mlp"]["fc2_w"]["s"])
    else:
        assert torch.equal(blk["xattn"]["k_w"], fblk["xattn"]["k_w"][:, 32:])
        assert torch.equal(blk["attn"]["o_w"], fblk["attn"]["o_w"][32:])
        assert torch.equal(blk["mlp"]["fc1_b"], fblk["mlp"]["fc1_b"][128:])
    assert blk["attn"]["o_b"] is fblk["attn"]["o_b"]
    assert tw.local_heads(local, "encoder", TCFG) == TCFG.n_audio_head // 2
    one = tm.shard_params(full, _StandInMesh(2, 1, 1, 0))
    assert all(a is b for a, b in zip(tree_leaves(one), tree_leaves(full)))


def test_auto_mesh_off_without_a_world(monkeypatch):
    from manual_whisper_tpu_torch.pipeline.transcribe import _auto_mesh
    assert not torch.distributed.is_initialized()
    assert _auto_mesh() is None
    monkeypatch.setenv("MWX_AUTO_MESH", "false")
    assert _auto_mesh() is None


def test_load_model_without_mesh():
    from manual_whisper_tpu_torch.pipeline import load_model
    for mesh in ("auto", None):
        pipe = load_model("test", device="cpu", language="zh", mesh=mesh)
        assert pipe.mesh is None and pipe.data_parallel == 1
        assert pipe.model_group is None


# ---------------------------------------------------------------------------
# One 2-process gloo world: dp=2, then tp=2
# ---------------------------------------------------------------------------

WORLD_LINES = [("2x1", "inference", "greedy"), ("2x1", "inference", "int8"),
               ("2x1", "inference", "timestamps"),
               ("2x1", "inference", "beam"),
               ("2x1", "inference", "sampled"), ("2x1", "train", None),
               ("1x2", "inference", "greedy"),
               ("1x2", "inference", "timestamps"),
               ("1x2", "inference", "beam"),
               ("1x2", "inference", "sampled"), ("1x2", "train", None)]


@pytest.fixture(scope="module")
def world_report(tmp_path_factory):
    work = tmp_path_factory.mktemp("gloo_world")
    weights = tmp_path_factory.mktemp("no_weights")
    report = work / "report.json"
    dryrun.spawn(2, meshes="2x1,1x2", modes="greedy,int8,timestamps,beam,sampled",
                 report=str(report), timeout=WORLD_TIMEOUT, workdir=str(work),
                 env={"MWX_WEIGHTS_DIR": str(weights)})
    lines = json.loads(report.read_text())
    return {(f"{ln['mesh']['data']}x{ln['mesh']['model']}", ln["check"],
             ln.get("mode")): ln for ln in lines}


@pytest.mark.parametrize("key", WORLD_LINES,
                         ids=lambda k: "-".join(str(v) for v in k if v))
def test_gloo_world_matches_one_process(world_report, key):
    line = world_report[key]
    assert line["ok"], line
    dp, mp = (int(v) for v in key[0].split("x"))
    if key[1] == "train":
        assert line["q_w_local"] == [64, 64 // mp]
        assert line["mu_local"] == line["q_w_local"]
        assert all(line["errors"][k] <= line["tol"][k] for k in line["tol"])
        return
    assert line["times_equal"] and line["ranks_agree"]
    assert line["data_parallel"] == dp
    assert line["q_w_local_width"] == 64 // mp
    assert line["rows"] % dp == 0
    if key[2] == "sampled":
        assert line["text_equal_outside_tail"]
        assert set(line["rung_rows"]) == {"0", "1"}
    else:
        assert line["text_equal"]
    assert (line["beam_calls"] > 0) == (key[2] == "beam")


@pytest.mark.slow
def test_dryrun_dp2_tp2_subprocess(tmp_path):
    """4 processes, a dp=2 x tp=2 mesh (the JAX dry run's layout at 4)."""
    report = tmp_path / "report.json"
    dryrun.spawn(4, meshes="2x2", modes="greedy,timestamps",
                 report=str(report), timeout=560, workdir=str(tmp_path),
                 env={"MWX_WEIGHTS_DIR": str(tmp_path)})
    lines = json.loads(report.read_text())
    assert [ln["check"] for ln in lines] == ["inference", "inference",
                                             "train"]
    assert all(ln["ok"] and ln["mesh"] == {"data": 2, "model": 2}
               for ln in lines)

