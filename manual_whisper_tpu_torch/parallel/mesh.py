"""Data and tensor parallelism over ``torch.distributed`` (port of the JAX
``parallel/mesh.py``).

One process a device, as ``torchrun`` starts them (PyTorch's idiom; JAX
drives every chip from one controller).  ``make_mesh`` lays the world out
as a ``DeviceMesh`` with dims ``("data", "model")``:

- **data parallel**: each batch's rows are split in contiguous blocks over
  the ``data`` dim (``shard_batch``); every rank of a model group holds
  the same rows.
- **tensor parallel** (``model`` dim): Megatron column and row shards of
  the attention and MLP weights (``param_sharding_rules``, leaf for leaf
  the JAX rules).  JAX states the layout and XLA inserts the
  collectives; here the model functions run them
  (``models/whisper.py``): the local head count is the shard width over
  head_dim, a row-parallel product's partial sums are all-reduced over
  the model group (``reduce_from_model``) before its replicated bias is
  added, and in training a column-parallel product's input gradient is
  all-reduced (``copy_to_model``).  ``shard_params`` returns the rank's
  shards; the model functions take the model group as an argument, which
  their callers (the pipeline, the decoder, the train step) read from the
  mesh with ``axis_group``.

The process group is the caller's: ``torchrun`` (NCCL on GPUs) or
``init_process_group`` with the gloo backend on the CPU (see
``parallel/dryrun.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.quant import is_quantized

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1):
    """(data, model) ``DeviceMesh`` over the initialised world: one rank a
    device, ``model_parallel`` consecutive ranks a model group, the rest
    the data dim.  ``n_devices`` (default: the world size) must be the
    world size, since every rank of the world runs the program."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    if n_devices is not None and n_devices % model_parallel != 0:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model_parallel={model_parallel}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: run under "
            "torchrun, or call torch.distributed.init_process_group")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} "
                         "processes: launch one process a device")
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of ``axis``, or None where the axis holds one rank
    of a wider world (a data-parallel world's model dim: no collective to
    run).  A one-rank world's mesh keeps both groups, so that its
    collectives run as they would at scale (the one-device check of the
    mesh path)."""
    if axis_size(mesh, axis) == 1 and mesh.size() > 1:
        return None
    return mesh.get_group(axis)


# ---------------------------------------------------------------------------
# Sharding rules (JAX ``param_sharding_rules``, in the port's layout)
# ---------------------------------------------------------------------------

Spec = Tuple[Optional[str], ...]
_COL: Spec = (None, MODEL_AXIS)        # [K, N] split over N
_ROW: Spec = (MODEL_AXIS, None)        # [K, N] split over K
_REP: Spec = (None,)


def param_sharding_rules(params: Dict[str, Any]) -> Dict[str, Any]:
    """Spec tree for the port's Whisper weights (Megatron TP): a tuple of
    axis names a dimension, as JAX's ``PartitionSpec`` with the stacked
    layer axis dropped (the port keeps a list of layers).

    - attention q/k/v: column-parallel (output dim over ``model``); q_b and
      v_b split with them;
    - attention o: row-parallel (input dim over ``model``), o_b replicated;
    - MLP fc1 column-parallel (and fc1_b), fc2 row-parallel, fc2_b
      replicated;
    - embeddings, norms, positions and convolutions replicated."""
    def attn():
        return {"q_w": _COL, "q_b": (MODEL_AXIS,), "k_w": _COL,
                "v_w": _COL, "v_b": (MODEL_AXIS,), "o_w": _ROW,
                "o_b": _REP}

    def ln():
        return {"g": _REP, "b": _REP}

    def block(cross: bool):
        spec = {"ln1": ln(), "attn": attn(), "ln2": ln(),
                "mlp": {"fc1_w": _COL, "fc1_b": (MODEL_AXIS,),
                        "fc2_w": _ROW, "fc2_b": _REP}}
        if cross:
            spec["lnx"] = ln()
            spec["xattn"] = attn()
        return spec

    return {
        "encoder": {"pos": _REP, "conv1_w": _REP, "conv1_b": _REP,
                    "conv2_w": _REP, "conv2_b": _REP,
                    "blocks": [block(False)
                               for _ in params["encoder"]["blocks"]],
                    "ln_post": ln()},
        "decoder": {"tok_emb": _REP, "pos_emb": _REP,
                    "blocks": [block(True)
                               for _ in params["decoder"]["blocks"]],
                    "ln": ln()},
    }


def resolve_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """Spec tree matching ``params`` leaf for leaf (JAX ``sharding_pytree``):
    an int8 ``{q, s}`` weight's codes take the weight's spec and its
    per-output-channel scales drop the contraction axis (a column shard
    splits ``s``, a row shard keeps it whole); keys outside the rules
    replicate."""
    def resolve(p, rule):
        if is_quantized(p):
            return {"q": rule, "s": tuple(rule[:-2]) + tuple(rule[-1:])
                    if len(rule) >= 2 else rule}
        if isinstance(p, dict):
            return {k: resolve(v, rule.get(k, _REP)
                               if isinstance(rule, dict) else _REP)
                    for k, v in p.items()}
        if isinstance(p, list):
            return [resolve(v, r) for v, r in zip(p, rule)]
        return _REP if isinstance(rule, dict) else rule

    return resolve(params, param_sharding_rules(params))


def _split(t: torch.Tensor, spec: Spec, parts: int, index: int
           ) -> torch.Tensor:
    if MODEL_AXIS not in spec or parts == 1:
        return t
    dim = spec.index(MODEL_AXIS)
    if t.shape[dim] % parts:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} weight is not "
                         f"divisible by model_parallel={parts}")
    # a copy, so the full weight is not kept alive by a view
    return t.chunk(parts, dim=dim)[index].clone(
        memory_format=torch.contiguous_format)


def shard_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The rank's shards of ``params`` per ``param_sharding_rules`` (new
    tensors; replicated leaves are shared)."""
    parts, index = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)

    def shard(p, spec):
        if isinstance(p, dict) and isinstance(spec, dict):
            return {k: shard(p[k], spec[k]) for k in spec}
        if isinstance(p, list):
            return [shard(v, s) for v, s in zip(p, spec)]
        return _split(p, spec, parts, index)

    return shard(params, resolve_specs(params))


def shard_batch(batch, mesh):
    """The rank's rows of the leading (batch) axis of every leaf over the
    data dim, in contiguous blocks; rank-0 leaves (a temperature)
    replicate.  Leaves are tensors or numpy arrays; tuples, lists and
    dicts are walked."""
    parts, index = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)

    def take(x):
        if isinstance(x, (tuple, list)):
            return type(x)(take(v) for v in x)
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if getattr(x, "ndim", 0) == 0:
            return x
        return local_rows(x, parts, index)

    return take(batch)


def local_rows(x, parts: int, index: int):
    """Block ``index`` of ``parts`` equal blocks of x's leading axis."""
    n = x.shape[0]
    if n % parts:
        raise ValueError(f"{n} rows not divisible by data_parallel={parts}")
    step = n // parts
    return x[index * step:(index + 1) * step]


# ---------------------------------------------------------------------------
# Collectives of the model functions
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Before a column-parallel product: identity forward, the input
    gradient all-reduced over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """After a row-parallel product: the partial sums all-reduced over the
    model group forward, identity backward (each rank's partial product
    takes the whole output gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every data rank's ``x`` along the leading axis (rank
    order), on every rank; ``x`` unchanged without a group.  bf16 crosses
    as bytes (gloo moves no bf16)."""
    if group is None:
        return x
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts).view(x.dtype)


def all_true(flag: torch.Tensor, group) -> bool:
    """Whether ``flag`` (a bool tensor) is all true on every rank of
    ``group`` (this rank's answer without a group)."""
    done = flag.all()
    if group is None:
        return bool(done)
    done = done.to(torch.int32).reshape(1)
    dist.all_reduce(done, op=dist.ReduceOp.MIN, group=group)
    return bool(done)
