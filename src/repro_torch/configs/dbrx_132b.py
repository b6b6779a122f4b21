"""DBRX 132B: 16-expert top-4 fine-grained MoE. [hf:databricks/dbrx-base]

40L d_model=6144 48H (GQA kv=8, head_dim 128) d_ff=10752 vocab=100352.
trainable="attention" for the 132B distillation step (DESIGN.md §2).
"""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    experts_per_token=4,
    moe_every=1,
    had=HADConfig(),
    trainable="attention",
    remat=True,
)
