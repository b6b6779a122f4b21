"""Kimi K2 (1T total / 32B active): fine-grained MoE. [arXiv:2501.kimi2]

61L d_model=7168 64H (GQA kv=8, head_dim 112) per-expert d_ff=2048,
vocab=163840, MoE 384 experts top-8 every layer.

At 1T parameters the distillation step uses trainable="attention" (student
attention projections only; everything else tied to the frozen teacher) —
full-weights Adam at 1T cannot fit 512 x 16 GB (DESIGN.md §2). Experts
shard over the model axis (EP, 384/16=24 per chip) with FSDP on d_model.
"""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
    moe_every=1,
    had=HADConfig(),
    trainable="attention",
    remat=True,
)
