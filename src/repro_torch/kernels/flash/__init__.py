from .flash_attention import flash_attention, flash_attention_plain
from .ops import flash_attention_op

__all__ = ["flash_attention", "flash_attention_op", "flash_attention_plain"]
