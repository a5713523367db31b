from .attention import (
    flash_attention,
    flash_attention_with_lse,
    flash_backward_reference,
    reference_attention,
    reference_attention_with_lse,
)

__all__ = [
    "flash_attention",
    "flash_attention_with_lse",
    "flash_backward_reference",
    "reference_attention",
    "reference_attention_with_lse",
]
