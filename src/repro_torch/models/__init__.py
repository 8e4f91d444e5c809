"""Unified model API of the port.

Counterpart of ``repro.models``: ``Model`` dispatches on
``ModelConfig.family``, as the reference does:

* ``dense`` / ``moe`` / ``vlm`` -> :mod:`repro_torch.models.transformer`
* ``ssm``    -> a pure Mamba2 stack (:mod:`repro_torch.models.mamba2`)
* ``hybrid`` -> :mod:`repro_torch.models.hybrid` (the reference's Zamba2-style hybrid)
* ``zamba2`` -> :mod:`repro_torch.models.zamba2` (the published Zamba2 block;
  port-only, serving only)
* ``audio``  -> :mod:`repro_torch.models.encdec` (Whisper)

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
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..sharding import WHOLE, ModelAxis, Product
from . import common, encdec, hybrid, mamba2, transformer, zamba2
from .common import check_remat, rms_norm
from .transformer import BIG, ModelConfig, MoEConfig, Zamba2Config

__all__ = ["Model", "ModelConfig", "MoEConfig", "Zamba2Config", "BIG", "param_shapes", "param_dtypes",
           "param_axes", "split_products"]

State = Dict[str, Any]

PORTED = ("dense", "moe", "vlm", "ssm", "hybrid", "audio", "zamba2")
#: what the transformer path serves
_TRANSFORMER = ("dense", "moe", "vlm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}): one of {PORTED}")


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat ``name -> shape`` of the model's parameters, for every family
    (dots separate the levels of the reference's tree)."""
    _require_ported(cfg)
    if cfg.family in _TRANSFORMER:
        return transformer.param_shapes(cfg)
    if cfg.family == "hybrid":
        return hybrid.param_shapes(cfg)
    if cfg.family == "zamba2":
        return zamba2.param_shapes(cfg)
    if cfg.family == "audio":
        return encdec.param_shapes(cfg)
    layer = mamba2.layer_shapes(cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return {
        "embed": (cfg.vocab, cfg.d_model),
        **{f"mamba.{k}": (cfg.n_layers,) + s for k, s in layer.items()},
        "final_ln": (cfg.d_model,),
    }


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Flat ``name -> logical axes`` (:func:`param_shapes`' keys), for every
    family: the reference's axes tree, flattened as :mod:`repro_torch.convert`
    flattens its parameter tree."""
    _require_ported(cfg)
    if cfg.family in _TRANSFORMER:
        return transformer.param_axes(cfg)
    if cfg.family == "hybrid":
        return hybrid.param_axes(cfg)
    if cfg.family == "zamba2":
        return zamba2.param_axes(cfg)
    if cfg.family == "audio":
        return encdec.param_axes(cfg)
    return {"embed": ("vocab", "embed_tbl"),
            **{f"mamba.{k}": ("layers",) + a for k, a in mamba2.layer_axes().items()},
            "final_ln": ("embed",)}


def split_products(cfg: ModelConfig) -> Dict[str, Product]:
    """The products the ``model`` axis may split, with the leaves each reads
    (:func:`repro_torch.sharding.model_axis` turns them into a rank's plan),
    each family's own: the transformers' heads, ``ff``, experts and
    vocabulary (:func:`transformer.split_products`); the ssm family's SSM
    heads (:func:`mamba2.split_products`) and tied vocabulary; zamba2's SSM
    heads, its shared block's heads and ``ff``, and the vocabulary
    (:func:`hybrid.split_products`); whisper's heads (encoder, decoder and
    cross-attention alike), ``ff`` and vocabulary
    (:func:`encdec.split_products`).  The zamba2 family splits nothing and
    raises (:func:`zamba2.split_products`)."""
    _require_ported(cfg)
    if cfg.family in _TRANSFORMER:
        return transformer.split_products(cfg)
    if cfg.family == "hybrid":
        return hybrid.split_products(cfg)
    if cfg.family == "zamba2":
        return zamba2.split_products(cfg)
    if cfg.family == "audio":
        return encdec.split_products(cfg)
    return {**mamba2.split_products(cfg), "vocab": Product({"embed": 0}, cfg.vocab)}


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
    parameter but a mamba layer's ``a_log`` / ``d_skip`` / ``dt_bias``, which
    are float32 whatever the model's dtype.  The zamba2 family holds every
    leaf in ``cfg.dtype``, as the published checkpoint does (the scan reads
    those three in float32 all the same)."""
    if cfg.family == "zamba2":
        return {name: cfg.dtype for name in param_shapes(cfg)}
    return {
        name: mamba2.leaf_dtype(name.rsplit(".", 1)[-1], cfg.dtype)
        if name.startswith("mamba.") else cfg.dtype
        for name in param_shapes(cfg)
    }


class Model(nn.Module):
    """``storage`` is where the parameters' storage is allocated: zeros on
    the model's ``device`` by default, ``"meta"`` for none, for a caller that
    hands every parameter over with ``load_state_dict(..., assign=True)``
    (the server does so).  ``remat`` (``none | dots | full``) applies to
    :meth:`train_loss`, except in the ssm family, where the reference
    recomputes no layer either."""

    def __init__(
        self, cfg: ModelConfig, attn_impl: str = "chunked", ssd_impl: str = "chunked",
        device: DeviceLike = "cuda", *, storage: Optional[DeviceLike] = None,
        remat: str = "none",
    ):
        super().__init__()
        _require_ported(cfg)
        if ssd_impl not in mamba2.SSD_IMPLS:
            raise ValueError(f"unknown ssd impl {ssd_impl!r}: chunked or hopper")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.ssd_impl = ssd_impl
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
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        params = dict(self.named_parameters())
        if cfg.family in _TRANSFORMER:
            transformer.fill_params(cfg, params, generator)
        elif cfg.family == "hybrid":
            hybrid.fill_params(cfg, params, generator)
        elif cfg.family == "zamba2":
            zamba2.fill_params(cfg, params, generator)
        elif cfg.family == "audio":
            encdec.fill_params(cfg, params, generator)
        else:
            # the reference draws the ssm family's embedding from a plain normal
            for part in common.draw_blocks(params["embed"], common.DRAW_BLOCK):
                part.copy_(torch.randn(part.shape, generator=generator, device=self.device)
                           .mul_(0.02))
            mamba2.fill_mamba_layers(
                {k.split(".", 1)[1]: v for k, v in params.items() if k.startswith("mamba.")},
                generator, cfg.d_model,
            )
            params["final_ln"].zero_()
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

    def _cache_positions(self, batch: int, max_len: int) -> torch.Tensor:
        return torch.arange(max_len, dtype=torch.int32, device=self.device)[None].expand(
            batch, max_len
        )

    def _ssm_forward(
        self, tokens: torch.Tensor, ssm_states: Optional[torch.Tensor] = None,
        conv_states: Optional[torch.Tensor] = None, decode: bool = False,
    ) -> Tuple[torch.Tensor, State]:
        """The mamba stack of the ``ssm`` family: a loop over the stacked
        ``mamba.*`` leaves.  States passed in are updated in place; without
        them none is kept (training).  No layer is recomputed under ``remat``,
        as in the reference."""
        cfg, params = self.cfg, self.params
        h = transformer.embed(params["embed"], tokens, self._plan).to(cfg.dtype)
        h = mamba2.run_stack(cfg, common.layer_views(params["mamba"]), h, range(cfg.n_layers),
                             ssm_states, conv_states, decode, self.ssd_impl, self._plan)
        return rms_norm(h, params["final_ln"]), {"ssm": ssm_states, "conv": conv_states}

    def train_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token loss of ``batch["targets"]`` given ``batch["tokens"]``
        (targets ``< 0`` not counted), by the chunked cross-entropy; the vlm
        takes ``patch_embeds`` / ``mrope_positions`` and the audio family
        ``frame_embeds`` from ``batch``.  The ssm and audio families, and the
        hybrid, score through the tied head.  Gradients reach the parameters
        that ask for them (a trainer turns them on) through ``attn_impl``
        ``"xla"`` / ``"chunked"`` and ``ssd_impl="chunked"``; the kernels are
        forward only and raise."""
        cfg, params = self.cfg, self.params
        tokens, targets = batch["tokens"], batch["targets"]
        if cfg.family == "zamba2":
            raise NotImplementedError(
                f"{cfg.name}: the zamba2 family serves only; training waits for a backward of "
                "the SSD kernel (ROADMAP E3)")
        if cfg.family in _TRANSFORMER:
            h, _ = transformer.forward(
                cfg, params, tokens, attn_impl=self.attn_impl, remat=self.remat,
                patch_embeds=batch.get("patch_embeds"),
                mrope_positions=batch.get("mrope_positions"), tp=self._plan,
            )
            return transformer.lm_loss(cfg, params, h, targets, tp=self._plan)
        if cfg.family == "hybrid":
            h, _ = hybrid.forward(cfg, params, tokens, attn_impl=self.attn_impl,
                                  ssd_impl=self.ssd_impl, remat=self.remat, tp=self._plan)
            return hybrid.lm_head_loss(cfg, params, h, targets, tp=self._plan)
        if cfg.family == "ssm":
            h, _ = self._ssm_forward(tokens)
        else:   # audio
            enc = encdec.encode(cfg, params, batch["frame_embeds"], self.attn_impl, self._plan)
            h = encdec.decode_train(cfg, params, enc, tokens, self.attn_impl, self.remat,
                                    self._plan)
        tied = dataclasses.replace(cfg, tie_embeddings=True)
        return transformer.lm_loss(tied, {"embed": params["embed"]}, h, targets, tp=self._plan)

    def _hybrid_kv(self, batch: int, max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed ``(apps, B, max_len, Hkv, Dh)`` caches in ``cfg.dtype``, as the
        reference's hybrid keeps them (the dense family's are bfloat16)."""
        return self._kv(hybrid.n_attn_applications(self.cfg), batch, max_len)

    def _kv(self, n: int, batch: int, max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed ``(n, B, max_len, Hkv, Dh)`` caches in ``cfg.dtype`` of the
        K / V heads this rank computes (all of them off a mesh)."""
        cfg = self.cfg
        k0, k1 = self._plan.range("kv_heads", cfg.n_kv_heads)
        shape = (n, batch, max_len, k1 - k0, cfg.dh)
        return (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.dtype, device=self.device))

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
        (a decode state of this model, batch and ``max_len``; not the audio
        family's) is zeroed, filled in place and returned where the state
        would otherwise be made anew: a captured prefill then returns only
        tensors made outside its capture.

        The audio family returns the **encoder output** of
        ``batch["frame_embeds"]`` and the state ``{"kv", "enc", "pos"}``: empty
        ``(L, B, max_len, Hkv, Dh)`` self-attention caches in ``cfg.dtype``,
        the encoder output, and position 0 for every row.  The prompt's
        tokens give only the batch size, as in the reference."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        if out is None:
            pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        else:
            for leaf in out.values():
                for t in leaf if isinstance(leaf, tuple) else (leaf,):
                    t.zero_()
            pos = out["pos"].fill_(S)
        if cfg.family == "audio":
            enc = encdec.encode(cfg, self.params, batch["frame_embeds"], self.attn_impl,
                                self._plan)
            kv = self._kv(cfg.n_layers, B, max_len)
            return enc, {"kv": kv, "enc": enc, "pos": torch.zeros_like(pos)}
        if cfg.family in ("ssm", "hybrid", "zamba2"):
            ssm, conv = ((out["ssm"], out["conv"]) if out is not None
                         else mamba2.init_states(cfg, B, self.device, self._plan))
        if cfg.family == "ssm":
            h, state = self._ssm_forward(tokens, ssm, conv)
            return h, {**state, "pos": pos}
        if cfg.family == "hybrid":
            h, state = hybrid.forward(
                cfg, self.params, tokens, attn_impl=self.attn_impl, ssd_impl=self.ssd_impl,
                kv_caches=out["kv"] if out is not None else self._hybrid_kv(B, max_len),
                cache_positions=self._cache_positions(B, max_len),
                ssm_states=ssm, conv_states=conv, tp=self._plan, check_room=check_room,
            )
            return h, {**state, "pos": pos}
        if cfg.family == "zamba2":
            h, state = zamba2.forward(
                cfg, self.params, tokens, attn_impl=self.attn_impl, ssd_impl=self.ssd_impl,
                kv_caches=(out["kv"] if out is not None
                           else self._kv(zamba2.applications(cfg), B, max_len)),
                cache_positions=self._cache_positions(B, max_len),
                ssm_states=ssm, conv_states=conv, check_room=check_room,
            )
            return h, {**state, "pos": pos}
        k0, k1 = self._plan.range("kv_heads", cfg.n_kv_heads)
        caches = (out["kv"] if out is not None else
                  transformer.init_kv_cache(cfg, B, max_len, device=self.device,
                                            kv_heads=k1 - k0))
        h, caches = transformer.forward(
            cfg, self.params, tokens, attn_impl=self.attn_impl,
            kv_caches=caches, cache_positions=self._cache_positions(B, max_len),
            patch_embeds=batch.get("patch_embeds"), mrope_positions=batch.get("mrope_positions"),
            tp=self._plan, check_room=check_room,
        )
        return h, {"kv": caches, "pos": pos}

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
        cfg = self.cfg
        B = tokens.shape[0]
        pos = state["pos"] + 1
        if cfg.family == "ssm":
            h, new = self._ssm_forward(tokens, state["ssm"], state["conv"], decode=True)
            return h, {**new, "pos": pos}
        kv = state["kv"]
        cache_pos = self._cache_positions(B, kv[0].shape[2])
        if cfg.family == "audio":
            h, kv = encdec.decode_step(cfg, self.params, state["enc"], tokens,
                                       state["pos"][:, None], kv, cache_pos, self.attn_impl,
                                       self._plan)
            return h, {"kv": kv, "enc": state["enc"], "pos": pos}
        if cfg.family == "hybrid":
            h, new = hybrid.forward(
                cfg, self.params, tokens, positions=state["pos"][:, None],
                attn_impl=self.attn_impl, ssd_impl=self.ssd_impl, kv_caches=kv,
                cache_positions=cache_pos, ssm_states=state["ssm"],
                conv_states=state["conv"], decode=True, tp=self._plan, check_room=check_room,
            )
            return h, {**new, "pos": pos}
        if cfg.family == "zamba2":
            h, new = zamba2.forward(
                cfg, self.params, tokens, positions=state["pos"][:, None],
                attn_impl=self.attn_impl, ssd_impl=self.ssd_impl, kv_caches=kv,
                cache_positions=cache_pos, ssm_states=state["ssm"], conv_states=state["conv"],
                decode=True, check_room=check_room,
            )
            return h, {**new, "pos": pos}
        h, kv = transformer.forward(
            cfg, self.params, tokens, positions=state["pos"][:, None],
            attn_impl=self.attn_impl, kv_caches=kv, cache_positions=cache_pos, tp=self._plan,
            check_room=check_room,
        )
        return h, {"kv": kv, "pos": pos}

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        """The logits this rank computes: its block of the vocabulary where
        the plan splits it (``lm_head``, or ``embed.T`` where tied: the ssm,
        hybrid, zamba2 and audio families tie theirs)."""
        if self.cfg.family in _TRANSFORMER:
            return transformer.lm_head(self.cfg, self.params, h)
        return h @ self.params["embed"].T.to(h.dtype)

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
