"""Jamba 1.5 Large (398B total): Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer. [arXiv:2403.19887; hf]

72L d_model=8192 64H (GQA kv=8, head_dim 128) d_ff=24576 vocab=65536.
Attention sits at position 4 of each 8-layer block (Jamba block layout);
Mamba layers use d_state=16, expand=2 (Jamba uses Mamba-1-style settings).
HAD applies to the attention layers only (1-in-8); trainable="attention"
keeps the distillation step feasible at 398B (DESIGN.md §2).
"""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    layer_pattern="MMMMAMMM",
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=32,
    had=HADConfig(),
    trainable="attention",
    remat=True,
)
