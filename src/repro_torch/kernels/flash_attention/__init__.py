from .ops import flash_attention
