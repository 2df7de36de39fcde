"""Model configuration schema shared by all assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio

    # transformer backbone
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # attention flavour
    qk_norm: bool = False
    window: Optional[int] = None     # sliding-window size (None = full attn)
    rope_theta: float = 10000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # hybrid / ssm layer pattern: tuple of block kinds repeated to n_layers.
    # kinds: "attn" (global), "local" (windowed attn), "rglru", "mlstm", "slstm"
    pattern: Tuple[str, ...] = ("attn",)

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500              # encoder frames after the conv-stub

    # modality frontend stubs
    vision_prefix: int = 0           # patch-embedding prefix length (phi-3-v)
    audio_frontend: bool = False     # whisper conv stub

    # numerics / training
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "full"              # "none" | "full" | "dots"
    tie_embeddings: bool = False

    # notes for DESIGN/roofline bookkeeping
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
            f"{self.arch}: n_heads={self.n_heads} not divisible by kv={self.n_kv_heads}"
        )

    # -- derived quantities -----------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expand the repeating pattern to n_layers entries."""
        kinds = []
        while len(kinds) < self.n_layers:
            kinds.extend(self.pattern)
        return tuple(kinds[: self.n_layers])

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        D, H, Kv, hd, F, V = (
            self.d_model,
            self.n_heads,
            self.n_kv_heads,
            self.head_dim,
            self.d_ff,
            self.vocab,
        )
        total = V * D  # embed
        if not self.tie_embeddings:
            total += V * D
        for kind in self.layer_kinds():
            if kind in ("attn", "local"):
                total += D * (H * hd) + 2 * D * (Kv * hd) + (H * hd) * D  # qkvo
                if self.n_experts > 0:
                    total += self.n_experts * 3 * D * F + D * self.n_experts
                elif F > 0:
                    total += 3 * D * F  # swiglu
                total += 2 * D
            elif kind == "rglru":
                # conv4 + in/out proj + gates (Griffin recurrent block) + mlp
                total += 2 * D * D + 4 * D + 3 * D + 2 * D
                if F > 0:
                    total += 3 * D * F + 2 * D
            elif kind == "mlstm":
                total += D * (H * hd) * 3 + (H * hd) * D + 2 * (H * hd) + 2 * D
            elif kind == "slstm":
                total += 4 * D * D + 4 * D + 2 * D
        if self.enc_dec:
            # encoder blocks (attn + mlp) + decoder cross-attention
            enc_block = D * (H * hd) + 2 * D * (Kv * hd) + (H * hd) * D + 3 * D * F + 2 * D
            total += self.n_enc_layers * enc_block
            total += self.n_layers * (D * (H * hd) + 2 * D * (Kv * hd) + (H * hd) * D + D)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dense_moe = self.n_experts * 3 * D * F
        active_moe = self.top_k * 3 * D * F
        n_moe_layers = sum(1 for k in self.layer_kinds() if k in ("attn", "local"))
        return self.param_count() - n_moe_layers * (dense_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (arch × input-shape) cell."""

    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")
