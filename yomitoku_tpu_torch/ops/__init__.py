"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see ops/attention.py, ops/mlp.py, ops/deformable_attention.py,
ops/bottleneck.py, ops/stage.py and csrc/)."""

from ._common import launches, layer_norm, reset_launches
from .attention import (
    fused_attention,
    fused_attention_block,
    fused_attention_block_ln,
    fused_attention_block_ln_int8,
    fused_attention_block_ln_int8_packed,
    fused_attention_block_ln_int8_reference,
    fused_attention_block_ln_packed,
    fused_attention_block_ln_reference,
    fused_attention_block_reference,
    fused_attention_heads,
    fused_attention_heads_reference,
    fused_attention_reference,
)
from .bottleneck import bottleneck_reference, conv_reference, fold_bn, fused_bottleneck
from .deformable_attention import (
    ms_deformable_attention,
    ms_deformable_attention_reference,
)
from .mlp import (
    fused_mlp,
    fused_mlp_ln,
    fused_mlp_ln_int8,
    fused_mlp_ln_int8_reference,
    fused_mlp_ln_reference,
    fused_mlp_reference,
    hidden_chunk,
    quantize_rows_reference,
    quantize_weight_int8,
)
from .stage import fused_identity_stage, fused_identity_stage_reference

__all__ = [
    "bottleneck_reference",
    "conv_reference",
    "fold_bn",
    "fused_attention",
    "fused_attention_block",
    "fused_attention_block_ln",
    "fused_attention_block_ln_int8",
    "fused_attention_block_ln_int8_packed",
    "fused_attention_block_ln_int8_reference",
    "fused_attention_block_ln_packed",
    "fused_attention_block_ln_reference",
    "fused_attention_block_reference",
    "fused_attention_heads",
    "fused_attention_heads_reference",
    "fused_attention_reference",
    "fused_bottleneck",
    "fused_identity_stage",
    "fused_identity_stage_reference",
    "fused_mlp",
    "fused_mlp_ln",
    "fused_mlp_ln_int8",
    "fused_mlp_ln_int8_reference",
    "fused_mlp_ln_reference",
    "fused_mlp_reference",
    "hidden_chunk",
    "launches",
    "layer_norm",
    "ms_deformable_attention",
    "ms_deformable_attention_reference",
    "quantize_rows_reference",
    "quantize_weight_int8",
    "reset_launches",
]
