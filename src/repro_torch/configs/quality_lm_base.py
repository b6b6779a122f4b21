"""QuALITY long-context proxy model (paper §4.3 used T5-Base; here a
decoder LM of the same scale runs the synthetic retrieval-QA benchmark
across context lengths with N scaled linearly)."""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="quality-lm-base",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=2048,
    vocab_size=32128,
    had=HADConfig(topn_frac=0.117, n_min=15),  # paper: 15@128 .. 120@1024
    trainable="all",
    remat=False,
)
