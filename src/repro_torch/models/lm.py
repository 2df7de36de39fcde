"""The language model: embeddings → layers → final norm → head.

Torch counterpart of ``repro/models/lm.py`` for decoder-only models whose
layers are attention blocks ("attn"/"local") or RG-LRU recurrent blocks
("rglru"), each with a dense or MoE FFN.  The parameters live in the
module; layers are an ``nn.ModuleList`` in layer order (the reference's
scanned groups and unscanned tail are one list here, see
:mod:`.convert`).  Matrices are stored in the compute dtype (the reference
keeps f32 and casts at every use, which gives the same numbers); norm
weights stay in the parameter dtype and are read in f32.

Each layer's decode cache is a dict: k and v buffers for an attention
layer, the recurrent state h and conv for an "rglru" layer.  Not ported
yet, and raising: the vision prefix (phi-3-vision), the encoder-decoder
(whisper), the xLSTM blocks ("mlstm", "slstm"), ``loss_fn`` (training,
with remat).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from . import blocks
from .blocks import LayerCache
from .common import ParamSpec, dtype_of, init_tensor, rms_norm


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Block(nn.Module):
    """One residual block; its parameters carry the reference's names."""

    def __init__(self, cfg: ModelConfig, kind: str, model: "Model"):
        super().__init__()
        self.kind = kind
        self.spec: ParamSpec = blocks.block_spec(cfg, kind)
        for name, (shape, _axes, _init) in self.spec.items():
            self.register_parameter(name, _param(shape, model.storage_dtype(shape), model.device))

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters(recurse=False))


class Model(nn.Module):
    """A decoder-only LM bound to a ``ModelConfig``, on one device.

    ``device=None`` means the card and raises without one; pass
    ``device="cpu"`` for the CPU.  Parameters are allocated uninitialized:
    call ``init_params`` or load them (``convert.params_from_jax``).
    """

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        if cfg.vision_prefix > 0 or cfg.enc_dec:
            raise NotImplementedError(
                f"{cfg.arch}: the vision prefix and the encoder-decoder are not ported yet"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)
        self.pdtype = dtype_of(cfg.param_dtype)
        D, V = cfg.d_model, cfg.vocab
        self.embed_table = _param((V, D), self.dtype, self.device)
        self.final_norm = _param((D,), self.pdtype, self.device)
        self.unembed_w = None if cfg.tie_embeddings else _param((D, V), self.dtype, self.device)
        self.layers = nn.ModuleList(Block(cfg, kind, self) for kind in cfg.layer_kinds())

    def storage_dtype(self, shape) -> torch.dtype:
        """Matrices in the compute dtype, vectors (norm weights) in the
        parameter dtype."""
        return self.dtype if len(shape) >= 2 else self.pdtype

    # -- parameter construction ----------------------------------------------------
    def param_inits(self) -> Dict[str, object]:
        """Initializer of every parameter, by its name in the module."""
        inits: Dict[str, object] = {"embed_table": "normal", "final_norm": "ones"}
        if self.unembed_w is not None:
            inits["unembed_w"] = "normal"
        for i, layer in enumerate(self.layers):
            inits.update({f"layers.{i}.{n}": s[2] for n, s in layer.spec.items()})
        return inits

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None) -> "Model":
        """Fill every parameter from the spec tables: truncated normal at
        ±2σ (σ = 0.02 for "normal"), zeros or ones, drawn in f32 on the
        model's device.  Seeded by ``generator`` (default seed 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        inits = self.param_inits()
        for name, p in self.named_parameters():
            p.copy_(init_tensor(p.shape, inits[name], generator))
        return self

    # -- embedding / head -----------------------------------------------------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed_table[tokens]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed_table.T if self.unembed_w is None else self.unembed_w
        return x @ w

    # -- full forward (train / prefill) ---------------------------------------------
    @torch.no_grad()
    def forward(
        self, batch: Dict[str, torch.Tensor], collect_cache: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[List[LayerCache]]]:
        """Returns (logits (B,S,V), aux loss summed over layers, per-layer
        caches or None)."""
        hidden, aux, caches = self._hidden(batch["tokens"], collect_cache)
        return self.unembed(hidden), aux, caches

    def _hidden(self, tokens: torch.Tensor, collect_cache: bool):
        B, S = tokens.shape
        x = self.embed(tokens)
        positions = torch.arange(S, device=self.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        caches = []
        for layer in self.layers:
            x, cache, a = blocks.block_forward(self.cfg, layer.kind, layer.params(), x, positions)
            aux = aux + a
            if collect_cache:
                caches.append(cache)
        return rms_norm(x, self.final_norm), aux, caches if collect_cache else None

    def loss_fn(self, batch):
        raise NotImplementedError("training (loss_fn, remat) is a later slice of the port")

    # -- prefill ---------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, List[LayerCache]]:
        """Returns (last-position logits (B,1,V), per-layer decode caches);
        only the last position is unembedded."""
        hidden, _, caches = self._hidden(batch["tokens"], collect_cache=True)
        return self.unembed(hidden[:, -1:]), caches

    # -- decode ----------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> List[LayerCache]:
        return [
            blocks.block_init_cache(self.cfg, layer.kind, batch, max_seq, self.dtype, self.device)
            for layer in self.layers
        ]

    @torch.no_grad()
    def decode_step(
        self, cache: List[LayerCache], token: torch.Tensor, pos: int
    ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """One token for the whole batch: token (B,1) integer, pos a Python
        int.  Each layer's cache is updated in place; the same list is
        returned."""
        x = self.embed(token)
        for layer, layer_cache in zip(self.layers, cache):
            x, _ = blocks.block_decode(self.cfg, layer.kind, layer.params(), x, layer_cache, int(pos))
        return self.unembed(rms_norm(x, self.final_norm)), cache
