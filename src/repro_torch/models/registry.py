"""Build models by arch id, and grow a prefill cache into a decode buffer.

Torch counterpart of ``repro/models/registry.py`` (``build``,
``build_from_config``, ``extend_cache``).  The reference's input specs and
cell skip rules serve its dry-run and are not ported.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .. import configs
from ..configs.base import ModelConfig
from ..device import DeviceLike
from .blocks import ATTENTION_KINDS, LayerCache
from .lm import Model


def build_from_config(cfg: ModelConfig, device: DeviceLike = None, seed: int = 0) -> Model:
    """A model on ``device`` (None: the card) with weights drawn from
    ``seed`` by ``Model.init_params``."""
    model = Model(cfg, device)
    return model.init_params(torch.Generator(device=model.device).manual_seed(seed))


def build(arch: str, smoke: bool = False, device: DeviceLike = None, seed: int = 0) -> Model:
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    return build_from_config(cfg, device, seed)


def extend_cache(model: Model, cache: List[LayerCache], max_seq: int) -> List[LayerCache]:
    """Zero-pad each attention layer's KV buffers along the sequence up to
    ``max_seq`` ("attn") or ``min(window, max_seq)`` ("local"), so decoding
    can continue past the prefill length.  Recurrent states are
    size-invariant and are copied as they are.  New tensors; the input is
    left as it was (decode updates the caches in place)."""
    out = []
    for layer, sub in zip(model.layers, cache):
        if layer.kind not in ATTENTION_KINDS:
            out.append({name: t.clone() for name, t in sub.items()})
            continue
        target = min(model.cfg.window, max_seq) if layer.kind == "local" else max_seq
        out.append({
            name: F.pad(t, (0, 0, 0, 0, 0, max(target - t.shape[1], 0))) for name, t in sub.items()
        })
    return out
