"""Logical-axis sharding rules on a ``torch.distributed`` ``DeviceMesh``.

Counterpart of ``repro.sharding``.  Every parameter and activation carries a
tuple of *logical* axis names (:func:`repro_torch.models.param_axes`); a
per-run rule table maps logical names to mesh axes.  The production meshes
(:mod:`repro_torch.launch.mesh`) have axes ``("data", "model")`` on one pod
and ``("pod", "data", "model")`` on two.

The rule table is the reference's:

* ``embed``/``ff``/``heads``/``vocab``   -> ``model``
* ``layers``/norm scales                 -> replicated
* ``batch``                             -> data parallel over ``(pod, data)``
* ``expert``                            -> expert parallel over ``model`` when
  the expert count divides the model axis; otherwise experts replicate and
  ``ff_expert`` takes the model axis;
* optional FSDP: parameters also shard their ``embed`` axis over the data
  axes (zero-3 style).

Where the reference builds a ``NamedSharding(mesh, PartitionSpec)``, the port
builds a :class:`Sharding`: the same spec (for each tensor dim ``None``, a
mesh axis name or a tuple of them) and the DTensor placements it means, one
per mesh dim (``Shard(d)`` or ``Replicate()``).  A tensor dim sharded over two
mesh axes (``batch`` -> ``("pod", "data")``) has ``Shard(d)`` on both mesh
dims; DTensor orders the shards by mesh dim, outer first, which is the
order of the names in the spec and in the reference's ``PartitionSpec``.

**Running on a mesh.**  The port computes on local tensors, as XLA's FSDP
does inside its layer scan: each rank gathers one layer's weights to full
where the layer reads them (:func:`unshard`, :class:`GatheredStack`) and
runs the model on its rows of the batch.  The backward of a gather reduces
the gradient over the data axes (the ranks there saw other rows) and keeps
this rank's shard; the ranks of the ``model`` axis compute the same values,
so a gradient is only cut there.  No op of the model runs through DTensor
dispatch, so none needs a DTensor sharding rule (the embedding's lookup, the
MoE capacity path's ``index_add_`` and the rest run on local tensors).  What
is not sharded is the work: the ``model`` axis shards storage (parameters,
moments, caches), not the products over ``heads`` / ``ff`` / ``vocab``, and
the experts are gathered, not dispatched; there is no tensor- or
expert-parallel product in the port (ROADMAP Queue C).  Collectives are the
functional ones (``torch.ops._c10d_functional``); a mesh dim of size 1 issues
none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

Spec = Tuple[Any, ...]
#: the mesh axes a batch is split over; the others (``model``) hold replicas
DATA_AXES = ("pod", "data")


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of ``mesh``, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> mesh axis (or None=replicate, or tuple of mesh axes)."""

    table: Tuple[Tuple[str, Any], ...]

    def get(self, logical: Optional[str]):
        if logical is None:
            return None
        for name, mesh_ax in self.table:
            if name == logical:
                return mesh_ax
        return None

    def spec(self, axes: Optional[Tuple[Optional[str], ...]]) -> Spec:
        if axes is None:
            return ()
        return tuple(self.get(a) for a in axes)


def default_rules(
    mesh,
    *,
    n_experts: int = 0,
    fsdp: bool = False,
    sequence_parallel: bool = False,
) -> ShardingRules:
    axes = mesh_axes(mesh)
    model_ax = "model" if "model" in axes else None
    data_axes = tuple(a for a in DATA_AXES if a in axes)
    dp: Any = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)
    model_size = axes.get("model", 1) if model_ax else 1

    expert_ax: Any = None
    ff_expert_ax: Any = model_ax
    if n_experts and model_ax and n_experts % model_size == 0:
        expert_ax, ff_expert_ax = model_ax, None  # clean EP

    table = [
        # parameters
        ("vocab", model_ax),
        ("embed", dp if fsdp else None),
        ("embed_tbl", None),  # vocab matrices: never FSDP the D dim
        ("embed2", None),
        ("heads", model_ax),
        ("ff", model_ax),
        ("expert", expert_ax),
        ("ff_expert", ff_expert_ax),
        ("expert_dim", None),
        ("layers", None),
        # activations
        ("batch", dp),
        ("seq", model_ax if sequence_parallel else None),
        ("kv_seq", None),
        ("head_dim", None),
        ("act_embed", None),
    ]
    return ShardingRules(table=tuple(table))


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, mesh_ax) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in _names(mesh_ax))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where one tensor lives on ``mesh``: ``spec`` gives, for each tensor dim,
    the mesh axes that shard it (the reference's ``PartitionSpec``; missing
    trailing dims are replicated)."""

    mesh: Any
    spec: Spec

    def __post_init__(self):
        order = list(self.mesh.mesh_dim_names)
        used = [a for entry in self.spec for a in _names(entry)]
        if len(set(used)) != len(used) or any(a not in order for a in used):
            raise ValueError(f"spec {self.spec} does not fit mesh axes {tuple(order)}")
        for entry in self.spec:
            idx = [order.index(a) for a in _names(entry)]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} must name mesh axes in mesh order {order}")

    @classmethod
    def of(cls, t: DTensor) -> "Sharding":
        """The sharding a DTensor has."""
        names = t.device_mesh.mesh_dim_names
        spec: list = [()] * t.dim()
        for name, p in zip(names, t.placements):
            if isinstance(p, Shard):
                spec[p.dim] += (name,)
        return cls(t.device_mesh, tuple(None if not e else e[0] if len(e) == 1 else e
                                        for e in spec))

    @property
    def device(self) -> torch.device:
        """Where this rank's blocks live."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    @property
    def placements(self) -> Tuple[Placement, ...]:
        names = list(self.mesh.mesh_dim_names)
        out: list = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            for a in _names(entry):
                out[names.index(a)] = Shard(d)
        return tuple(out)

    def tensor_dim(self, axis: str) -> Optional[int]:
        """The tensor dim mesh axis ``axis`` shards, or None."""
        for d, entry in enumerate(self.spec):
            if axis in _names(entry):
                return d
        return None

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = _axis_size(self.mesh, entry)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {entry} ({n})")
            out[d] //= n
        return tuple(out)

    def local_slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of a tensor of ``shape``: for a dim over several
        mesh axes the shard index counts the outer axis first."""
        sizes = mesh_axes(self.mesh)
        coord = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        local = self.local_shape(shape)
        out = []
        for d in range(len(shape)):
            idx = 0
            for a in _names(self.spec[d] if d < len(self.spec) else None):
                idx = idx * sizes[a] + coord[a]
            out.append(slice(idx * local[d], (idx + 1) * local[d]))
        return tuple(out)

    def drop_leading(self) -> "Sharding":
        """The sharding of one slice along dim 0 (one layer of a stack)."""
        if self.spec and self.spec[0] is not None:
            raise ValueError(f"dim 0 of {self.spec} is sharded")
        return Sharding(self.mesh, self.spec[1:])


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _map(fn, tree, like=None):
    if _is_axes_leaf(tree):
        return fn(tree, like)
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, None if like is None else like[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, None if like is None else like[i])
                          for i, v in enumerate(tree))
    raise TypeError(f"not an axes tree: {tree!r}")


def logical_to_sharding(axes_tree, mesh, rules: ShardingRules, like=None):
    """Map a logical-axes tree (dicts / tuples of axis-name tuples; the port's
    flat ``name -> axes`` dict is one) to :class:`Sharding` s.

    When ``like`` (a matching tree of tensors, anything with ``.shape``) is
    given, any dimension not divisible by its assigned mesh axes is replicated
    instead: whisper's vocab 51866 and mamba2's 50280 do not divide the 16-way
    model axis, so their embedding tables replicate."""

    def to_sharding(axes, leaf):
        mesh_axes_ = [rules.get(a) for a in axes]
        if leaf is not None:
            mesh_axes_ = [ax if ax is None or d % _axis_size(mesh, ax) == 0 else None
                          for d, ax in zip(leaf.shape, mesh_axes_)]
        return Sharding(mesh, tuple(mesh_axes_))

    return _map(to_sharding, axes_tree, like)


def batch_specs(mesh, batch_shapes: Dict[str, Tuple[int, ...]], rules: ShardingRules
                ) -> Dict[str, Sharding]:
    """Shardings for a model input batch: dim0 = batch (data parallel)."""
    return {name: Sharding(mesh, (rules.get("batch"),) + (None,) * (len(shape) - 1))
            for name, shape in batch_shapes.items()}


def check_divisibility(cfg, mesh, global_batch: int) -> list:
    """Static validation that a (config x mesh x batch) cell is shardable.

    Returns a list of human-readable problems (empty = OK).  Called by the
    dry-run before the step runs, so failures are diagnosed, not debugged."""
    problems = []
    sizes = mesh_axes(mesh)
    model = sizes.get("model", 1)
    data = math.prod(sizes.get(a, 1) for a in DATA_AXES)
    if global_batch % data and global_batch >= data:
        problems.append(f"global_batch {global_batch} % data {data} != 0")
    if cfg.n_heads % model and cfg.n_heads >= model:
        problems.append(f"n_heads {cfg.n_heads} % model {model} != 0")
    return problems


# ---------------------------------------------------------------------------
# Running on a mesh
# ---------------------------------------------------------------------------


def data_rank(mesh) -> Tuple[int, int]:
    """``(index, count)`` of this rank's slice of the batch: its coordinate on
    the data axes, outer first, and their product."""
    sizes = mesh_axes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx, n = 0, 1
    for a in DATA_AXES:
        if a in sizes:
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
    return idx, n


def distribute(full: torch.Tensor, sharding: Sharding) -> DTensor:
    """A DTensor of ``full`` on ``sharding``: every rank holds the same
    ``full`` (drawn from one seed, or read from one checkpoint) and keeps its
    block, so no collective runs.  A block that is the whole tensor is
    ``full`` itself, not a copy."""
    sl = sharding.local_slices(full.shape)
    local = full[sl]
    if local.shape != full.shape:
        local = local.clone()
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    c10d = torch.ops._c10d_functional
    y = c10d.all_gather_into_tensor(x.movedim(dim, 0).contiguous(), group.size(),
                                    group.group_name)
    return c10d.wait_tensor(y).movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    c10d = torch.ops._c10d_functional
    y = c10d.reduce_scatter_tensor(x.movedim(dim, 0).contiguous(), "sum", group.size(),
                                   group.group_name)
    return c10d.wait_tensor(y).movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_reduce(x.contiguous(), "sum", group.group_name))


def _steps(sharding: Sharding, keep: Tuple[int, ...]):
    """``(axis, size, tensor dim or None)`` of each mesh axis of size > 1 that
    is not a ``keep`` dim's, outer first."""
    out = []
    for axis, size in mesh_axes(sharding.mesh).items():
        d = sharding.tensor_dim(axis)
        if size > 1 and (d is None or d not in keep):
            out.append((axis, size, d))
    return out


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sharding, keep):
        ctx.sharding, ctx.keep = sharding, keep
        mesh = sharding.mesh
        for axis, _, d in reversed(_steps(sharding, keep)):   # inner axis first
            if d is not None:
                x = _all_gather(x, d, mesh.get_group(axis))
        return x

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.sharding.mesh
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        for axis, size, d in _steps(ctx.sharding, ctx.keep):   # outer axis first
            if axis in DATA_AXES:          # other rows on the other ranks: sum
                grad = (_all_reduce(grad, mesh.get_group(axis)) if d is None
                        else _reduce_scatter(grad, d, mesh.get_group(axis)))
            elif d is not None:            # the same values everywhere: cut
                grad = grad.tensor_split(size, dim=d)[coord[axis]]
        return grad, None, None


def unshard(local: torch.Tensor, sharding: Sharding, keep: Tuple[int, ...] = ()) -> torch.Tensor:
    """This rank's block ``local`` of a tensor laid out by ``sharding``,
    gathered to full along every sharded dim but the ``keep`` dims (a batch
    dim whose rows are this rank's).  Differentiable: the gradient is summed
    over the data axes that do not shard a ``keep`` dim and cut back to this
    rank's block.  With nothing to gather it is ``local`` itself."""
    if not _steps(sharding, keep):
        return local
    return _Unshard.apply(local, sharding, tuple(keep))


def reshard(full: torch.Tensor, sharding: Sharding, keep: Tuple[int, ...] = ()) -> torch.Tensor:
    """The inverse of :func:`unshard` without a collective: this rank's block
    of the dims that ``unshard`` gathered."""
    sl = list(sharding.local_slices(_global_shape(full.shape, sharding, keep)))
    for d in keep:
        sl[d] = slice(None)
    return full[tuple(sl)]


def _global_shape(shape, sharding: Sharding, keep) -> Tuple[int, ...]:
    out = list(shape)
    for d in keep:
        if d < len(sharding.spec):
            out[d] *= _axis_size(sharding.mesh, sharding.spec[d])
    return tuple(out)


def all_reduce_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the data axes (a no-op where they are 1 wide)."""
    for axis, size in mesh_axes(mesh).items():
        if axis in DATA_AXES and size > 1:
            x = _all_reduce(x, mesh.get_group(axis))
    return x


def all_reduce_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over every rank of ``mesh``."""
    for axis, size in mesh_axes(mesh).items():
        if size > 1:
            x = _all_reduce(x, mesh.get_group(axis))
    return x


def replicas(sharding: Sharding) -> int:
    """How many ranks hold each block: the sizes of the mesh axes that shard no dim."""
    return math.prod(size for axis, size in mesh_axes(sharding.mesh).items()
                     if sharding.tensor_dim(axis) is None)


class GatheredStack:
    """A layer-stacked group of local blocks whose layer ``i``
    (:meth:`layer`, read by :func:`repro_torch.models.common.layer_params`)
    gathers each weight to full where the layer reads it.  Inside a
    rematerialised layer the gather is redone in backward, so at most the
    layers being computed are ever held whole."""

    def __init__(self, locals_: Dict[str, torch.Tensor], shardings: Dict[str, Sharding]):
        self._locals = locals_
        self._shardings = {k: s.drop_leading() for k, s in shardings.items()}

    def layer(self, i: int) -> "_Layer":
        return _Layer(self, i)


class _Layer(Mapping):
    def __init__(self, stack: GatheredStack, i: int):
        self._stack, self._i = stack, i

    def __getitem__(self, name: str) -> torch.Tensor:
        s = self._stack
        return unshard(s._locals[name][self._i], s._shardings[name])

    def __contains__(self, name) -> bool:
        return name in self._stack._locals

    def __iter__(self) -> Iterator[str]:
        return iter(self._stack._locals)

    def __len__(self) -> int:
        return len(self._stack._locals)


def gathered_tree(params: Mapping[str, torch.Tensor], shardings: Mapping[str, Sharding],
                  axes: Mapping[str, Tuple[Optional[str], ...]]) -> Dict[str, Any]:
    """The tree a model binds on a mesh (:meth:`repro_torch.models.Model.bind`):
    from the flat ``params`` (DTensors, or their local blocks), each group
    whose leaves are layer-stacked (first logical axis ``"layers"``) as a
    :class:`GatheredStack`, every other leaf gathered to full now."""
    tree: Dict[str, Any] = {}
    stacks: Dict[str, Tuple[dict, dict]] = {}
    for name, p in params.items():
        local = p.to_local() if isinstance(p, DTensor) else p
        group, _, leaf = name.rpartition(".")
        if axes[name][:1] == ("layers",):
            blocks, shard = stacks.setdefault(group, ({}, {}))
            blocks[leaf], shard[leaf] = local, shardings[name]
            continue
        node = tree
        for part in group.split(".") if group else ():
            node = node.setdefault(part, {})
        node[leaf] = unshard(local, shardings[name])
    for group, (blocks, shard) in stacks.items():
        tree[group] = GatheredStack(blocks, shard)
    return tree
