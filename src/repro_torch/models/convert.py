"""Load the JAX package's parameter tree into a port ``Model``.

The reference stacks the layers of each pattern position on a leading
``n_groups`` axis (``groups/blk{i}_{kind}``) and keeps the layers that do
not fill a whole pattern as ``tail/tail{i}_{kind}``.  Layer ``g·P + i`` of
the port is ``groups/blk{i}_{kind}[g]``; layer ``n_groups·P + i`` is
``tail/tail{i}_{kind}``.  The tree holds numpy arrays (``np.asarray`` of
each leaf), so this module needs nothing of jax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .lm import Model


def _leaves(model: Model, tree: Mapping) -> Dict[str, np.ndarray]:
    """The tree's arrays, by the port's parameter names."""
    cfg = model.cfg
    P = len(cfg.pattern)
    n_groups = cfg.n_layers // P
    out = {"embed_table": tree["embed"]["table"], "final_norm": tree["final_norm"]["w"]}
    if "unembed" in tree:
        out["unembed_w"] = tree["unembed"]["w"]
    for idx, layer in enumerate(model.layers):
        g, i = divmod(idx, P)
        if g < n_groups:
            sub = tree["groups"][f"blk{i}_{layer.kind}"]
            out.update({f"layers.{idx}.{n}": a[g] for n, a in sub.items()})
        else:
            sub = tree["tail"][f"tail{idx - n_groups * P}_{layer.kind}"]
            out.update({f"layers.{idx}.{n}": a for n, a in sub.items()})
    return out


@torch.no_grad()
def params_from_jax(model: Model, tree: Mapping) -> Model:
    """Copy every parameter of ``tree`` (the reference's ``init_params``
    output, leaves as numpy arrays) into ``model``, cast to its storage
    dtype.  Raises if a name or a shape does not match."""
    leaves = _leaves(model, tree)
    params = dict(model.named_parameters())
    if set(leaves) != set(params):
        raise ValueError(
            f"parameter names differ: only in the tree {sorted(set(leaves) - set(params))}, "
            f"only in the model {sorted(set(params) - set(leaves))}"
        )
    for name, p in params.items():
        a = np.array(leaves[name], dtype=np.float32)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {a.shape}, model shape {tuple(p.shape)}")
        p.copy_(torch.from_numpy(a))
    return model
