from .decode_attention import decode_attention, decode_attention_plain
from .ops import decode_attention_op

__all__ = ["decode_attention", "decode_attention_op", "decode_attention_plain"]
