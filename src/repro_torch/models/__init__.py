"""Unified model API of the port.

Counterpart of ``repro.models``: ``Model`` dispatches on
``ModelConfig.family``, as the reference does, through one table,
:data:`FAMILIES`, from the family's name to its module:

* ``dense`` / ``moe`` / ``vlm`` -> :mod:`repro_torch.models.transformer`
* ``ssm``    -> :mod:`repro_torch.models.ssm` (a pure Mamba2 stack)
* ``hybrid`` -> :mod:`repro_torch.models.hybrid` (the reference's Zamba2-style hybrid)
* ``zamba2`` -> :mod:`repro_torch.models.zamba2` (the published Zamba2 block;
  port-only, serving only)
* ``audio``  -> :mod:`repro_torch.models.encdec` (Whisper)

Every family module has the same interface, which is all that ``Model``
and this module's functions call:

    param_shapes(cfg) / param_axes(cfg) / split_products(cfg)
    fill_params(cfg, params, generator)
    train_loss(cfg, params, batch, *, attn_impl, ssd_impl, remat, tp)
    new_state(cfg, batch, max_len, device, tp)   -> the decode state's leaves, no "pos"
    prefill(cfg, params, batch, max_len, device, state, *, attn_impl, ssd_impl, tp,
            check_room)                          -> (hidden, leaves); state None: new_state's
    decode_step(cfg, params, tokens, state, *, attn_impl, ssd_impl, tp, check_room)
                                                 -> (hidden, leaves), updated in place
    STATE           the decode state's leaves besides "pos" ("kv", "ssm", "conv", "enc")
    TIED_HEAD       whether the head is ``embed.T`` whatever ``cfg.tie_embeddings`` says
    FLOAT32_LEAVES  the parameters kept in float32 whatever ``cfg.dtype``

A new family is one such module and one entry of :data:`FAMILIES`.

``Model`` is an ``nn.Module`` that owns the layer-stacked parameters under the
reference's key names, each in the reference's dtype (:func:`param_dtypes`:
``cfg.dtype`` but for the float32 leaves of a mamba layer), so
``state_dict()`` / ``load_state_dict()`` speak the reference's tree (see
:mod:`repro_torch.convert`).  The entry points used by the server and the
trainer:

    init(generator)                 -> self, parameters drawn at random, in place
    train_loss(batch)               -> scalar loss; batch["tokens"], ["targets"]
                                       (and the vlm's / audio family's inputs)
    prefill(batch, max_len)         -> (hidden, cache_state); batch["tokens"], and
                                       for the vlm batch["patch_embeds"] and
                                       batch["mrope_positions"] where given, for
                                       the audio family batch["frame_embeds"]
    decode_step(tokens, state)      -> (hidden, new_state)
    logits(hidden)                  -> vocabulary logits
    greedy(hidden)                  -> the token of the largest logit
    abstract_init()                 -> (parameters on ``meta``, logical axes)
    bind(params, plan)              -> a context in which the entry points run on
                                       ``params`` instead of the model's own (and,
                                       on a mesh, compute this rank's share of
                                       the products ``plan`` splits)

The launch counters of the kernels the entry points run are read and raised
through :mod:`repro_torch.kernels`' functions, handed on here to the runtime.
"""

from __future__ import annotations

import contextlib
from types import ModuleType
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..kernels import add_launches, launch_counts, launches_since, telemetry_counts
from ..sharding import WHOLE, ModelAxis, Product
from . import encdec, hybrid, mamba2, ssm, transformer, zamba2
from .common import check_remat
from .transformer import BIG, ModelConfig, MoEConfig, Zamba2Config

__all__ = ["Model", "ModelConfig", "MoEConfig", "Zamba2Config", "BIG", "FAMILIES", "family",
           "param_shapes", "param_dtypes", "param_axes", "split_products", "add_launches",
           "launch_counts", "launches_since", "telemetry_counts"]

State = Dict[str, Any]

#: each family's module, by the family's name
FAMILIES: Dict[str, ModuleType] = {
    "dense": transformer, "moe": transformer, "vlm": transformer, "ssm": ssm,
    "hybrid": hybrid, "zamba2": zamba2, "audio": encdec,
}


def family(cfg: ModelConfig) -> ModuleType:
    """The module of ``cfg``'s family (:data:`FAMILIES`)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}): one of {tuple(FAMILIES)}")
    return FAMILIES[cfg.family]


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat ``name -> shape`` of the model's parameters, for every family
    (dots separate the levels of the reference's tree)."""
    return family(cfg).param_shapes(cfg)


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Flat ``name -> logical axes`` (:func:`param_shapes`' keys), for every
    family: the reference's axes tree, flattened as :mod:`repro_torch.convert`
    flattens its parameter tree."""
    return family(cfg).param_axes(cfg)


def split_products(cfg: ModelConfig) -> Dict[str, Product]:
    """The products the ``model`` axis may split, with the leaves each reads
    (:func:`repro_torch.sharding.model_axis` turns them into a rank's plan):
    each family module's own.  The zamba2 family splits nothing and raises."""
    return family(cfg).split_products(cfg)


#: the decode state's leaves that hold heads a plan may split: the dim of
#: the heads, the product that splits them and the config field counting them
_STATE_HEADS = {"kv": (3, "kv_heads", "n_kv_heads"), "ssm": (2, "ssm_heads", "ssm_heads")}


def state_heads_dim(key: str, plan: ModelAxis) -> Optional[int]:
    """The dim of decode-state leaf ``key``'s heads where ``plan`` splits
    them, so that a rank's state holds the heads it computes; else None."""
    dim, product, _ = _STATE_HEADS.get(key, (None, None, None))
    return dim if dim is not None and plan.splits(product) else None


def rank_state(cfg: ModelConfig, key: str, x: torch.Tensor, plan: ModelAxis,
               kept: Tuple[int, ...] = ()) -> torch.Tensor:
    """Decode-state leaf ``key`` as this rank computes with it, from ``x``,
    whole along every dim but ``kept`` (there, this rank's block as the
    rules lay it): the heads it computes where ``plan`` splits them, and a
    conv state's channels (:func:`mamba2.rank_conv`)."""
    dim = state_heads_dim(key, plan)
    if dim is not None and dim not in kept:
        h0, h1 = plan.ranges[_STATE_HEADS[key][1]]
        x = x.narrow(dim, h0, h1 - h0)
    return mamba2.rank_conv(cfg, x, plan) if key == "conv" else x


def whole_state(cfg: ModelConfig, key: str, x: torch.Tensor, plan: ModelAxis,
                kept: Tuple[int, ...] = ()) -> torch.Tensor:
    """The inverse of :func:`rank_state`: the leaf whole along every dim but
    ``kept`` again, the ranks' heads and conv channels gathered over the
    ``model`` axis."""
    dim = state_heads_dim(key, plan)
    if dim is not None and dim not in kept:
        _, product, count = _STATE_HEADS[key]
        x = plan.gather(x, product, dim, units=getattr(cfg, count))
    return mamba2.whole_conv(cfg, x, plan) if key == "conv" else x


def param_dtypes(cfg: ModelConfig) -> Dict[str, torch.dtype]:
    """Flat ``name -> dtype``, the reference's: ``cfg.dtype`` for every
    parameter but the family's ``FLOAT32_LEAVES`` (a mamba layer's
    ``a_log`` / ``d_skip`` / ``dt_bias`` in the ssm and hybrid families),
    which are float32 whatever the model's dtype.  The zamba2 family holds
    every leaf in ``cfg.dtype``, as the published checkpoint does."""
    fp32 = family(cfg).FLOAT32_LEAVES
    return {name: torch.float32 if name in fp32 else cfg.dtype for name in param_shapes(cfg)}


class Model(nn.Module):
    """``storage`` is where the parameters' storage is allocated: zeros on
    the model's ``device`` by default, ``"meta"`` for none, for a caller that
    hands every parameter over with ``load_state_dict(..., assign=True)``
    (the server does so).  ``remat`` (``none | dots | full``) applies to
    :meth:`train_loss`, except in the ssm family, where the reference
    recomputes no layer either.  ``family`` is the family's module
    (:data:`FAMILIES`)."""

    def __init__(
        self, cfg: ModelConfig, attn_impl: str = "chunked", ssd_impl: str = "chunked",
        device: DeviceLike = "cuda", *, storage: Optional[DeviceLike] = None,
        remat: str = "none",
    ):
        super().__init__()
        self.family = family(cfg)
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.ssd_impl = mamba2.check_ssd_impl(ssd_impl)
        self.remat = check_remat(remat)
        self.device = resolve_device(device)
        self._bound: Optional[Mapping[str, Any]] = None
        self._plan: ModelAxis = WHOLE
        storage = self.device if storage is None else torch.device(storage)
        # storage only; init() or load_state_dict() gives it values.  The
        # parameters ask for no gradients: a trainer turns them on
        dtypes = param_dtypes(cfg)
        for name, shape in param_shapes(cfg).items():
            param = nn.Parameter(
                torch.zeros(shape, dtype=dtypes[name], device=storage), requires_grad=False
            )
            if "." in name:   # layers.*, mamba.*, shared_attn.*, enc.*, dec.*: a ParameterDict each
                group, leaf = name.split(".", 1)
                if group not in self._modules:
                    self.add_module(group, nn.ParameterDict())
                self._modules[group][leaf] = param
            else:
                self.register_parameter(name, param)

    # -- parameters ------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None, seed: int = 0) -> "Model":
        """Draw every parameter at random from ``generator`` (one on the
        model's device, seeded with ``seed``, if none is given), in place:
        a large leaf block by block, so the only memory beyond the weights is
        one block's float32 draw."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.family.fill_params(self.cfg, dict(self.named_parameters()), generator)
        return self

    @property
    def params(self) -> transformer.Params:
        """The parameters as the reference's nested tree (no copy), or the
        tree bound by :meth:`bind`."""
        if self._bound is not None:
            return self._bound
        return transformer.nest(dict(self.named_parameters()))

    @contextlib.contextmanager
    def bind(self, params: Mapping[str, Any], plan: ModelAxis = WHOLE) -> Iterator["Model"]:
        """Inside the context the entry points run on ``params`` (a nested
        tree with the reference's keys) instead of the model's own parameters:
        the meshed trainer and the dry-run pass each rank's weights
        (:func:`repro_torch.sharding.gathered_tree`) to a model whose own
        storage is ``meta``.  Every family then computes this rank's share
        of the products that ``plan`` (the one the tree was read by,
        :func:`repro_torch.sharding.model_axis`) splits, and its decode
        state holds that share's heads."""
        prev = self._bound, self._plan
        self._bound, self._plan = params, plan
        try:
            yield self
        finally:
            self._bound, self._plan = prev

    def abstract_init(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple[Optional[str], ...]]]:
        """``(parameters, logical axes)`` without allocating anything: each
        parameter an empty ``meta`` tensor of its shape and dtype, keyed as
        :func:`param_shapes`; the dry-run stands them in for the weights."""
        cfg = self.cfg
        dtypes = param_dtypes(cfg)
        params = {name: torch.empty(shape, dtype=dtypes[name], device="meta")
                  for name, shape in param_shapes(cfg).items()}
        return params, param_axes(cfg)

    # -- forward paths -----------------------------------------------------------

    def _impls(self) -> Dict[str, Any]:
        return {"attn_impl": self.attn_impl, "ssd_impl": self.ssd_impl, "tp": self._plan}

    def train_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token loss of ``batch["targets"]`` given ``batch["tokens"]``
        (targets ``< 0`` not counted), by the chunked cross-entropy; the vlm
        takes ``patch_embeds`` / ``mrope_positions`` and the audio family
        ``frame_embeds`` from ``batch``.  The ssm and audio families, and the
        hybrid, score through the tied head.  Gradients reach the parameters
        that ask for them (a trainer turns them on) through ``attn_impl``
        ``"xla"`` / ``"chunked"`` and ``ssd_impl="chunked"``; the kernels are
        forward only and raise.  The zamba2 family serves only and raises."""
        return self.family.train_loss(self.cfg, self.params, batch, remat=self.remat,
                                      **self._impls())

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int, check_room: bool = True,
                out: Optional[State] = None) -> Tuple[torch.Tensor, State]:
        """Processes the prompt; returns (hidden, decode state).  Attention
        runs over the whole cache: unwritten slots are hidden by ``kp <= qp``.
        ``max_len`` means nothing to the ssm family's state.  A prompt longer
        than ``max_len`` raises ``ValueError`` after one host read; with
        ``check_room=False`` (a prefill captured in a CUDA graph) the caller
        has checked its length on the host, and on the card nothing in the
        dense, moe, vlm, ssm and hybrid prefills reads a value back.  ``out``
        (a decode state of this model, batch and ``max_len``) is zeroed,
        filled in place and returned where the state would otherwise be made
        anew: a captured prefill then returns only tensors made outside its
        capture.  The audio family returns the encoder output
        (:func:`repro_torch.models.encdec.prefill`)."""
        B, S = batch["tokens"].shape
        state = None
        if out is None:
            pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        else:
            for leaf in out.values():
                for t in leaf if isinstance(leaf, tuple) else (leaf,):
                    t.zero_()
            pos = out["pos"].fill_(S)
            state = {k: v for k, v in out.items() if k != "pos"}
        h, state = self.family.prefill(self.cfg, self.params, batch, max_len, self.device, state,
                                       check_room=check_room, **self._impls())
        state.setdefault("pos", pos)     # the audio family's decoder starts at 0
        return h, state

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, state: State,
                    check_room: bool = True) -> Tuple[torch.Tensor, State]:
        """One new token per sequence against the cached state.  The caches
        and states in ``state`` are updated in place; the returned state
        shares them, with a new ``pos``.  Positions are the 1-D
        ``state["pos"]``: a vlm decodes with plain RoPE after an M-RoPE
        prefill, as the reference does.  A KV insert past the cache's end
        raises ``ValueError`` after one host read of the positions; with
        ``check_room=False`` (a step captured in a CUDA graph, which reads
        nothing back) the caller has checked them on the host
        (:func:`repro_torch.models.transformer.check_room`), a row past the
        end writes where the reference's clamped insert writes, and on the
        card nothing else in the dense, moe, vlm, ssm and hybrid steps reads
        a value back.  The audio step checks always."""
        pos = state["pos"] + 1
        h, new = self.family.decode_step(self.cfg, self.params, tokens, state,
                                         check_room=check_room, **self._impls())
        return h, {**new, "pos": pos}

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        """The logits this rank computes: its block of the vocabulary where
        the plan splits it (``lm_head``, or ``embed.T`` where tied: the ssm,
        hybrid, zamba2 and audio families tie theirs)."""
        return transformer.lm_head(self.cfg, self.params, h, tied=self.family.TIED_HEAD)

    @torch.no_grad()
    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary's logits (gathered over the ``model`` axis
        where the plan splits the vocabulary)."""
        return self._plan.gather(self._head(h), "vocab")

    @torch.no_grad()
    def greedy(self, h: torch.Tensor) -> torch.Tensor:
        """The index of the largest logit, the lowest on a tie, as
        ``logits(h).argmax(-1)``; where the plan splits the vocabulary, from
        each rank's best without gathering the logits."""
        return self._plan.argmax(self._head(h), "vocab")
