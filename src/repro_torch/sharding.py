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
does inside its layer scan: each rank reads one layer's weights where the
layer runs (:class:`GatheredStack`) and computes on its rows of the batch.
The data axes (``pod``, ``data``) hold fsdp shards: a weight is gathered
over them where it is read, and the backward of the gather sums the
gradient over them (the ranks there saw other rows) and keeps this rank's
shard.  On the ``model`` axis each rank computes **its share of the
products the rules shard** (Megatron's layout on local tensors).  A model
family declares which products may split, the leaves each reads and the
dim that holds its units (:class:`Product`,
:func:`repro_torch.models.split_products`); :func:`model_axis` reads this
rank's share off the leaves' shardings into a plan (:class:`ModelAxis`),
which the model computes under.  A leaf is read in one of three ways
(:data:`Take`): its storage block as it lies, where that block is the
rank's share; gathered over ``model`` and cut to the units the rank reads
(a K / V head cut across storage shards, a per-head vector the rules
replicate); or gathered and cut into several pieces, where the leaf's dim
holds segments one after another, some split by the product's units and
some read whole (:class:`Segments`: a mamba layer's input projection,
whose columns are ``z | x | B | C | dt``).  The families declare:

* attention by whole heads, where ``n_heads`` divides the axis (the
  transformers, zamba2's shared block, whisper's self- and
  cross-attention): the query projection column-parallel and the output
  projection row-parallel on the storage shard as it lies; the K / V heads
  a rank's query heads read are its own shard where ``n_kv_heads`` divides
  the axis, else gathered over it and cut to those heads.  Where
  ``n_heads`` does not divide the axis, attention is computed whole on
  every rank (GSPMD splits those heads below a head; the port does not);
* the MLPs over ``ff``, the MoE's routed experts over ``expert`` or
  ``ff_expert``; the router and the shared expert's gate run whole;
* a mamba layer by SSM heads: its heads' columns of the input projection
  and the conv with the B / C columns whole (every rank computes B and C),
  its heads of the per-head vectors, the norm scale and the output
  projection (row-parallel) as they lie; the gated norm's sum of squares is
  summed over the axis (:meth:`ModelAxis.all_sum`);
* the vocabulary: a vocab-parallel embedding lookup, the head
  column-parallel and the loss a vocab-parallel cross-entropy; greedy
  decoding takes the argmax across the shards.

A region split this way is entered by an identity whose backward sums the
gradient over the axis and left by a sum whose backward is the identity,
so the activations between regions (and the gradients of the leaves not
split) are the same on every rank of the axis, and a split leaf's gradient
is this rank's block.  A leaf read gathered and cut has its gradient
summed over ``model`` (each rank's holds its own units' part) and cut back
to this rank's block.  A leaf the rules shard over ``model`` whose product
stays whole is gathered over ``model`` and its gradient cut back to this
rank's block.  No op of the model runs through DTensor dispatch, so
none needs a DTensor sharding rule (the embedding's lookup, the MoE
capacity path's ``index_add_`` and the rest run on local tensors).
Collectives are the functional ones (``torch.ops._c10d_functional``); a
mesh dim of size 1 issues none.
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
    def forward(ctx, x, sharding, keep, partial):
        ctx.sharding, ctx.keep, ctx.partial = sharding, keep, partial
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
            if axis in DATA_AXES or ctx.partial:   # a part of the gradient on each rank: sum
                grad = (_all_reduce(grad, mesh.get_group(axis)) if d is None
                        else _reduce_scatter(grad, d, mesh.get_group(axis)))
            elif d is not None:            # the same values everywhere: cut
                grad = grad.tensor_split(size, dim=d)[coord[axis]]
        return grad, None, None, None


def unshard(local: torch.Tensor, sharding: Sharding, keep: Tuple[int, ...] = (),
            partial: bool = False) -> torch.Tensor:
    """This rank's block ``local`` of a tensor laid out by ``sharding``,
    gathered to full along every sharded dim but the ``keep`` dims (a batch
    dim whose rows are this rank's, a weight's dim split over ``model``).
    Differentiable: the gradient is summed over the data axes that do not
    shard a ``keep`` dim and cut back to this rank's block; with ``partial``
    (the ranks of the ``model`` axis each read another part of the result)
    it is summed over that axis too.  With nothing to gather and nothing to
    sum it is ``local`` itself."""
    if not _steps(sharding, keep):
        return local
    return _Unshard.apply(local, sharding, tuple(keep), partial)


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


# ---------------------------------------------------------------------------
# Products split over the model axis
# ---------------------------------------------------------------------------


class _EnterSplit(torch.autograd.Function):
    """Into a region split over the ``model`` axis: the identity; in
    backward each rank holds a part of the gradient, and the parts are summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _LeaveSplit(torch.autograd.Function):
    """Out of a region split over the ``model`` axis: the ranks' parts
    summed; in backward the identity (each rank's part needs the whole
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumSplit(torch.autograd.Function):
    """A sum over the ``model`` axis that every rank reads on (a norm's sum
    of squares over channels the ranks hold parts of): the ranks' parts
    summed; in backward too, since each rank's part of the gradient of the
    sum comes from its own channels."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


Range = Tuple[int, int]
#: how a rank reads a leaf whose product is split: ``("split", dim)`` keeps
#: the leaf's ``model``-axis block of ``dim`` as it lies; ``("slice", dim,
#: start, stop)`` gathers the leaf over the axis and takes ``start:stop`` of
#: ``dim`` (the K / V heads of a storage shard that cuts a head, a per-head
#: vector the rules replicate); ``("pieces", dim, ((start, stop), ...))``
#: gathers it and puts those ranges of ``dim`` together in order
#: (:class:`Segments`)
Take = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Segments:
    """A leaf dim that holds segments one after another, as a product reads
    it: ``parts`` ``(width, split)`` in order, ``width`` columns a unit of
    the product where ``split`` (that segment is ``units * width`` wide and
    a rank reads its units' columns), else the whole segment's width, which
    every rank reads whole.  A mamba layer's input projection, columns ``z |
    x | B | C | dt``: ``P``, ``P`` a head, ``2N`` whole, ``1`` a head."""

    dim: int
    parts: Tuple[Tuple[int, bool], ...]

    def take(self, units: Range, n: int) -> Take:
        """How a rank whose share is ``units`` of ``n`` reads the leaf."""
        pieces, at = [], 0
        for width, split in self.parts:
            if split:
                pieces.append((at + units[0] * width, at + units[1] * width))
                at += n * width
            else:
                pieces.append((at, at + width))
                at += width
        if len(pieces) == 1:
            return ("slice", self.dim, *pieces[0])
        return ("pieces", self.dim, tuple(pieces))


@dataclasses.dataclass(frozen=True)
class Product:
    """A product the ``model`` axis may split, as a model family declares it
    (:func:`repro_torch.models.split_products`): the leaves it reads, each
    with the dim that holds its units (or its :class:`Segments`), and the
    count of its units (heads, ``ff`` rows, experts, vocabulary rows), each
    ``width`` wide along those dims.  ``read_by`` ``(product, group)``: that
    product's units read this one's, ``group`` of them each (query heads
    reading their K / V head); this one is split where that one is, on the
    units a rank's share reads."""

    leaves: Mapping[str, Any]
    units: int
    width: int = 1
    read_by: Optional[Tuple[str, int]] = None


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """One rank's share of a model's products on the ``model`` axis
    (:func:`model_axis`): ``ranges`` maps each split product to this rank's
    ``(start, stop)`` of its units, ``takes`` each leaf those read to how it
    is read.  A product not in ``ranges`` is computed whole, and the methods
    leave its tensors as they are: :data:`WHOLE`, the plan off a mesh or on
    a 1-wide axis, splits nothing and issues no collective."""

    group: Any = None
    ranges: Mapping[str, Range] = dataclasses.field(default_factory=dict)
    takes: Mapping[str, Take] = dataclasses.field(default_factory=dict)

    def splits(self, *products: str) -> bool:
        return any(p in self.ranges for p in products)

    def range(self, product: str, units: int) -> Range:
        """This rank's units of ``product``: all ``units`` where it is whole."""
        return self.ranges.get(product, (0, units))

    def enter(self, x: torch.Tensor, *products: str) -> torch.Tensor:
        """``x`` into the region where ``products`` are split."""
        return _EnterSplit.apply(x, self.group) if self.splits(*products) else x

    def leave(self, x: torch.Tensor, *products: str) -> torch.Tensor:
        """A split region's part ``x`` out of it: the ranks' parts summed."""
        return _LeaveSplit.apply(x, self.group) if self.splits(*products) else x

    def enter_each(self, x: torch.Tensor, *regions: Tuple[str, ...]):
        """``x`` as each region (a tuple of products) reads it: the split
        regions share one entry (one sum of their gradients in backward),
        the others read ``x``."""
        xs = self.enter(x, *(p for r in regions for p in r))
        return [xs if self.splits(*r) else x for r in regions]

    def all_sum(self, x: torch.Tensor, *products: str) -> torch.Tensor:
        """``x`` summed over the axis where ``products`` are split, in
        forward and in backward (:class:`_SumSplit`); ``x`` itself where
        they are whole."""
        return _SumSplit.apply(x, self.group) if self.splits(*products) else x

    def cut(self, x: torch.Tensor, leaf: str, dim: int) -> torch.Tensor:
        """``x`` cut along ``dim`` as the plan reads leaf ``leaf``'s
        pieces (a decode state laid out like that leaf's dim); ``x`` itself
        where the plan reads the leaf whole or as it lies."""
        take = self.takes.get(leaf)
        if take is None or take[0] == "split":
            return x
        return _cut(x, dim, take)

    def leave_sum(self, *parts: Tuple[Tuple[str, ...], torch.Tensor]) -> torch.Tensor:
        """The sum of ``(region, part)`` pairs: the split regions' parts
        summed over the axis in one, then the whole regions' added."""
        split = [t for r, t in parts if self.splits(*r)]
        terms = [t for r, t in parts if not self.splits(*r)]
        if split:
            terms.insert(0, _LeaveSplit.apply(sum(split[1:], split[0]), self.group))
        return sum(terms[1:], terms[0])

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The element-wise max over the axis (no gradient)."""
        c10d = torch.ops._c10d_functional
        return c10d.wait_tensor(c10d.all_reduce(x.detach().contiguous(), "max",
                                                self.group.group_name))

    def gather(self, x: torch.Tensor, product: str, dim: int = -1,
               units: Optional[int] = None) -> torch.Tensor:
        """The whole of ``x``, whose ``dim`` holds this rank's units of
        ``product``: the ranks' blocks put together in rank order (no
        gradient), each of the ``units`` once where several ranks read one
        (a cut K / V head); ``x`` itself where ``product`` is whole."""
        if not self.splits(product):
            return x
        dim %= x.dim()
        full = _all_gather(x.detach(), dim, self.group)
        if units is not None and full.shape[dim] > units:
            full = full.unflatten(dim, (units, -1)).select(dim + 1, 0)
        return full

    def argmax(self, local: torch.Tensor, product: str) -> torch.Tensor:
        """The index of the largest element along the last dim, the lowest
        on a tie, as ``argmax`` of the whole picks it; where ``product`` is
        split, from each rank's first maximum in its units, then the first
        rank that holds the largest."""
        if not self.splits(product):
            return local.argmax(dim=-1)
        idx = local.argmax(dim=-1, keepdim=True)
        vals = self.gather(local.gather(-1, idx), product)
        idxs = self.gather(idx + self.ranges[product][0], product)
        return idxs.gather(-1, vals.argmax(dim=-1, keepdim=True))[..., 0]


#: the plan that splits nothing
WHOLE = ModelAxis()


def read_range(units: Range, group: int) -> Optional[Range]:
    """The units another product's ``units`` read, ``group`` of them each
    (a GQA group: query heads reading their K / V head): whole groups, or
    the one group they lie in.  None where they do neither, so that a rank's
    units would not read alike."""
    start, stop = units
    if start % group == 0 and stop % group == 0:
        return start // group, stop // group
    if start // group == (stop - 1) // group and group % (stop - start) == 0:
        return start // group, start // group + 1
    return None


def model_axis(products: Mapping[str, Product], shardings: Mapping[str, Sharding]
               ) -> ModelAxis:
    """This rank's plan (:class:`ModelAxis`), read off the leaves'
    ``shardings`` (flat names).  A product is split where its units divide
    the axis and the rules shard every leaf it reads over ``model`` along
    its units' dim, so that each rank's storage block is its share (a leaf
    of :class:`Segments` is read gathered and cut, however it lies).  A
    product read by another (``Product.read_by``) is split where that one
    is: its leaves as they lie where their block is the units the rank's
    share reads, else gathered over the axis and cut to them.  :data:`WHOLE`
    where the axis is 1 wide or nothing is split."""
    mesh = next(iter(shardings.values())).mesh
    M = mesh_axes(mesh).get("model", 1)
    if M == 1:
        return WHOLE
    r = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["model"]
    ranges: Dict[str, Range] = {}
    takes: Dict[str, Take] = {}
    for name, p in products.items():
        leaves = {n: d for n, d in p.leaves.items() if n in shardings}
        own = (r * p.units // M, (r + 1) * p.units // M)
        lies = (bool(leaves) and p.units % M == 0
                and all(shardings[n].tensor_dim("model") == d for n, d in leaves.items()
                        if not isinstance(d, Segments)))
        if p.read_by is None:
            if lies:
                ranges[name] = own
                takes.update({n: d.take(own, p.units) if isinstance(d, Segments)
                              else ("split", d) for n, d in leaves.items()})
            continue
        reader, group = p.read_by
        units = read_range(ranges[reader], group) if reader in ranges else None
        if units is None:       # the reader stays whole too
            if ranges.pop(reader, None) is not None:
                takes = {n: t for n, t in takes.items() if n not in products[reader].leaves}
            continue
        ranges[name] = units
        takes.update({n: ("split", d) if lies and units == own
                      else ("slice", d, units[0] * p.width, units[1] * p.width)
                      for n, d in leaves.items()})
    return ModelAxis(mesh.get_group("model"), ranges, takes) if ranges else WHOLE


def read(local: torch.Tensor, sharding: Sharding, take: Optional[Take] = None) -> torch.Tensor:
    """A leaf's local block ``local`` as a rank computes with it: gathered
    to full, or as the plan's ``take`` says."""
    if take is None:
        return unshard(local, sharding)
    if take[0] == "split":
        return unshard(local, sharding, keep=(take[1],))
    return _cut(unshard(local, sharding, partial=True), take[1], take)


def _cut(full: torch.Tensor, dim: int, take: Take) -> torch.Tensor:
    """The ranges of ``dim`` a ``"slice"`` or ``"pieces"`` take names."""
    pieces = (take[2:],) if take[0] == "slice" else take[2]
    parts = [full.narrow(dim, a, b - a) for a, b in pieces]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


class GatheredStack:
    """A layer-stacked group of local blocks whose layer ``i``
    (:meth:`layer`, read by :func:`repro_torch.models.common.layer_views`)
    reads each weight where the layer runs (:func:`read`): gathered over the
    data axes, and over ``model`` unless the plan splits its product
    (``takes``).  Inside a rematerialised layer the gather is redone in
    backward, so at most the layers being computed are ever held gathered."""

    def __init__(self, locals_: Dict[str, torch.Tensor], shardings: Dict[str, Sharding],
                 takes: Optional[Mapping[str, Take]] = None):
        self._locals = locals_
        self._shardings = {k: s.drop_leading() for k, s in shardings.items()}
        self._takes = dict(takes or {})

    def layer(self, i: int) -> "_Layer":
        return _Layer(self, i)


class _Layer(Mapping):
    def __init__(self, stack: GatheredStack, i: int):
        self._stack, self._i = stack, i

    def __getitem__(self, name: str) -> torch.Tensor:
        s = self._stack
        return read(s._locals[name][self._i], s._shardings[name], s._takes.get(name))

    def __contains__(self, name) -> bool:
        return name in self._stack._locals

    def __iter__(self) -> Iterator[str]:
        return iter(self._stack._locals)

    def __len__(self) -> int:
        return len(self._stack._locals)


def gathered_tree(params: Mapping[str, torch.Tensor], shardings: Mapping[str, Sharding],
                  axes: Mapping[str, Tuple[Optional[str], ...]],
                  plan: ModelAxis = WHOLE) -> Dict[str, Any]:
    """The tree a model binds on a mesh (:meth:`repro_torch.models.Model.bind`):
    from the flat ``params`` (DTensors, or their local blocks), each group
    whose leaves are layer-stacked (first logical axis ``"layers"``) as a
    :class:`GatheredStack`, every other leaf read now, as ``plan`` says."""
    tree: Dict[str, Any] = {}
    stacks: Dict[str, Tuple[dict, dict, dict]] = {}
    for name, p in params.items():
        local = p.to_local() if isinstance(p, DTensor) else p
        group, _, leaf = name.rpartition(".")
        take = plan.takes.get(name)
        if axes[name][:1] == ("layers",):
            blocks, shard, takes = stacks.setdefault(group, ({}, {}, {}))
            blocks[leaf], shard[leaf] = local, shardings[name]
            if take is not None:     # a layer's slice: one dim fewer
                takes[leaf] = (take[0], take[1] - 1, *take[2:])
            continue
        node = tree
        for part in group.split(".") if group else ():
            node = node.setdefault(part, {})
        node[leaf] = read(local, shardings[name], take)
    for group, (blocks, shard, takes) in stacks.items():
        tree[group] = GatheredStack(blocks, shard, takes)
    return tree
