"""The ('data', 'model') grid of processes (counterpart of
`icl_tpu/parallel/mesh.py`: `create_mesh`, `DEFAULT_PARAM_RULES`,
`param_shardings`, `shard_state`).

The JAX package lays its devices out as a ('data', 'model') mesh and lets
XLA insert the collectives. The port runs one process per rank and
reduces explicitly. `create_mesh(data=D, model=M)` lays the D*M processes
of the initialised group out as JAX lays out devices (`devices.reshape(
data, model)`): rank r has data index r // M and model index r % M. The
data group holds the D ranks of one model index: they hold the same
shards of different batch rows, and every batch reduction
(`collectives`) runs over it. The model group holds the M ranks of one
data index: they hold the same rows and different shards of the weights
that `PARAM_RULES` split (Megatron's column -> row pairs, `tensor`).
Without an initialised group, or with one process, there is nothing to
reduce: every function of `collectives` is then the identity and the step
is the one-process step, bit for bit.

`PARAM_RULES` is `DEFAULT_PARAM_RULES` rewritten for the port's state_dict
keys (the reference key layout). A flax kernel [in, out] split on 'out'
(P(None, 'model')) is a split of torch's weight dim 0 and of the bias; a
split on 'in' (P('model', None)) is a split of dim 1, the bias
replicated; a conv kernel [k, k, k, in, out] likewise, as dims 0 and 1 of
[out, in, k, k, k]. Where inside an axis each rank's share lies is the
port's own: GSPMD reshards behind the scenes, explicit tensor parallelism
cannot, so the splits follow the heads. `qkv`'s output [3*H*hd] is three
pieces q, k, v and `fc_kv`'s [2*H*hd] two, k and v: each rank holds the
rows of its heads in every piece (`HEAD_ALIGNED`), and `proj`'s input
columns, which are the heads' channels, follow. Every other split is one
contiguous block a rank. An attention layer whose head count does not
divide by M stays replicated as a whole (qkv, fc_q, fc_kv and proj), as
does a pair whose split dim does not divide; its numbers are the same
(`replicated_layers` lists them: at M = 2 the 3-head Swin-T stage 1 of
Swin-UNet, its 3-head decoder stage and SwinUNETR's stage 1; at M = 4 also
the 2-head ICL decoders of U-Net-ICL and the 6-head ones of the Swin
models).

`shard_model(model, mesh)` (counterpart of `shard_state`) builds nothing:
it takes the whole model, made from the seed on every rank exactly as one
process makes it, and keeps each rank's slice, so tensor parallelism over
M ranks starts from the weights of one process bit for bit.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch
import torch.distributed as dist

from icl_tpu_torch.device import resolve_device

# (regex over the state_dict key, the dim it is split on)
PARAM_RULES: list[tuple[str, int]] = [
    (r"(.*\.)?mlp2\.fc1\.(weight|bias)", 0),
    (r"(.*\.)?mlp2\.fc2\.weight", 1),
    (r"(.*\.)?attn\.qkv\.(weight|bias)", 0),
    (r"(.*\.)?attn\.fc_q\.(weight|bias)", 0),
    (r"(.*\.)?attn\.fc_kv\.(weight|bias)", 0),
    (r"(.*\.)?attn\.proj\.weight", 1),
    (r"(.*\.)?mlp\.fc1\.(weight|bias)", 0),
    (r"(.*\.)?mlp\.fc2\.weight", 1),
    (r"(.*\.)?mlp\.linear1\.(weight|bias)", 0),
    (r"(.*\.)?mlp\.linear2\.weight", 1),
    (r"(.*\.)?(encoder10\.layer|decoder5\.conv_block)\.conv1\.conv\.weight", 0),
    (r"(.*\.)?(encoder10\.layer|decoder5\.conv_block)\.conv2\.conv\.weight", 1),
]
# layers whose output is pieces of heads: q, k, v (qkv) and k, v (fc_kv)
HEAD_ALIGNED = {"qkv": 3, "fc_kv": 2}
_ATTENTION_LEAVES = ("qkv", "fc_q", "fc_kv", "proj")
_COMPILED = [(re.compile(pattern), dim) for pattern, dim in PARAM_RULES]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the grid: the data group (None when the
    data axis has one rank), its rank in it and its size, this rank's
    device; the model group (None when the model axis has one rank), its
    rank in it and its size; the process's global rank and the number of
    processes."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    model_group: Optional[dist.ProcessGroup] = None
    model_rank: int = 0
    model_size: int = 1
    process_index: int = 0
    process_count: int = 1

    def model_ranks(self) -> list[int]:
        """The global ranks of this rank's model group, by model index."""
        first = self.rank * self.model_size
        return list(range(first, first + self.model_size))


# Process-wide, as the groups themselves are: a group is made once, by every
# process together, and the layers and losses read the reduction group at call
# time (the counterpart of the mesh that `icl_tpu/ops/flags.py` records).
_GROUPS: dict = {}  # (world, data, model) -> (data group, model group) of this process
_ACTIVE: Optional[tuple] = None  # (the mesh `create_mesh` made last, its world)


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_group() -> Optional[dist.ProcessGroup]:
    """The default process group when one of more than one process is
    initialised, else None."""
    return dist.group.WORLD if _world()[1] > 1 else None


def _active() -> Optional[Mesh]:
    if _ACTIVE is None or _world()[1] == 1 or _ACTIVE[1] != id(dist.group.WORLD):
        return None
    return _ACTIVE[0]


def data_group() -> Optional[dist.ProcessGroup]:
    """The data group of the mesh `create_mesh` made last, or the default
    group of more than one process when no mesh was made; None with one
    process (nothing to reduce)."""
    mesh = _active()
    return world_group() if mesh is None else mesh.group


def _groups(data: int, model: int) -> tuple:
    """This process's (data group, model group), made once per (data,
    model) and world. Every process calls `dist.new_group` for every group,
    in the same order, also for the groups it is not in, as
    torch.distributed requires."""
    rank, world = _world()
    key = (id(dist.group.WORLD), data, model)
    if key not in _GROUPS:
        mine_data = mine_model = None
        if model > 1:
            for d in range(data):
                ranks = list(range(d * model, (d + 1) * model))
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine_model = g
        if data > 1:
            if model == 1:
                mine_data = dist.group.WORLD
            else:
                for m in range(model):
                    ranks = list(range(m, world, model))
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        mine_data = g
        _GROUPS[key] = (mine_data, mine_model)
    return _GROUPS[key]


def create_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """The (data, model) mesh over every process of the initialised group
    (one process when none is), with the JAX signature: `data` -1 means
    the number of processes // `model`. Raises ValueError when `model`
    does not divide the processes or data * model is not their number.
    `device` as `resolve_device` takes it (None: the CUDA card); with more
    than one process a CUDA device without an index becomes this rank's,
    `cuda:{rank % device count}` (ranks beyond the cards share them). The
    mesh becomes the one `data_group` reads."""
    global _ACTIVE
    rank, world = _world()
    if model < 1 or world % model:
        raise ValueError(f"model={model} does not divide the {world} processes")
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f"data={data} x model={model} is not the {world} processes")
    device = resolve_device(device)
    if world > 1 and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    data_g, model_g = _groups(data, model) if world > 1 else (None, None)
    mesh = Mesh(data_g, rank // model, data, device, model_g, rank % model, model, rank, world)
    if world > 1:
        _ACTIVE = (mesh, id(dist.group.WORLD))
    return mesh


def _rule_dim(key: str) -> Optional[int]:
    for pattern, dim in _COMPILED:
        if pattern.fullmatch(key):
            return dim
    return None


def _full_len(module: torch.nn.Module, name: str, dim: int) -> int:
    """The whole length along `dim` of parameter `name` of `module`,
    sharded or not (a parallel layer records its whole size)."""
    split = getattr(module, "splits", {}).get(name)
    return split.full if split is not None else getattr(module, name).shape[dim]


def _layer_of(key: str) -> tuple[str, str]:
    """(the layer that a matched key belongs to, its leaf): the attention
    module for `attn.*`, the MLP or the residual block for the others."""
    parts = key.split(".")
    leaf = parts[-2]
    if leaf == "conv" and parts[-3] in ("conv1", "conv2"):  # `<block>.conv1.conv.weight`
        return ".".join(parts[:-3]), parts[-3]
    return ".".join(parts[:-2]), leaf


def tp_plan(model: torch.nn.Module, model_size: int) -> tuple[dict, dict]:
    """({state_dict key: (dim, pieces)} of the parameters split over
    `model_size` ranks, {layer: why it stays replicated}) by `PARAM_RULES`,
    on a whole or an already sharded model."""
    modules = dict(model.named_modules())
    by_layer: dict = {}
    for key, _ in model.named_parameters():
        dim = _rule_dim(key)
        if dim is not None:
            layer, leaf = _layer_of(key)
            by_layer.setdefault(layer, []).append((key, leaf, dim))
    plan, replicated = {}, {}
    for layer, keys in by_layer.items():
        owner = modules[layer]
        why = None
        if all(leaf in _ATTENTION_LEAVES for _, leaf, _ in keys):
            if owner.num_heads % model_size:
                why = f"{owner.num_heads} heads"
        for key, _, dim in keys:
            module_name, name = key.rsplit(".", 1)
            n = _full_len(modules[module_name], name, dim)
            pieces = HEAD_ALIGNED.get(module_name.rsplit(".", 1)[-1], 1)
            if why is None and n % (pieces * model_size):
                why = f"{key} dim {dim} of {n}"
        if why is not None:
            replicated[layer] = why
            continue
        for key, _, dim in keys:
            plan[key] = (dim, HEAD_ALIGNED.get(key.split(".")[-2], 1))
    return plan, replicated


def param_shardings(model: torch.nn.Module, mesh: Mesh) -> dict:
    """For every state_dict key of `model`, the dim it is split on over
    the mesh's model axis, or None (replicated)."""
    plan, _ = tp_plan(model, mesh.model_size)
    return {k: plan[k][0] if k in plan else None for k in model.state_dict()}


def replicated_layers(model: torch.nn.Module, model_size: int) -> dict:
    """{layer: why} of the layers `PARAM_RULES` name that stay replicated
    over `model_size` ranks: heads or a dim that do not divide."""
    return tp_plan(model, model_size)[1]


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """The model with each rank's slice of every leaf `param_shardings`
    splits, in place (`tensor.shard_layers`): column- and row-parallel
    layers under the same keys, attention layers on their heads. The
    identity when the model axis has one rank."""
    if mesh.model_size == 1:
        return model
    from icl_tpu_torch.parallel.tensor import shard_layers

    plan, _ = tp_plan(model, mesh.model_size)
    shard_layers(model, plan, mesh)
    return model
