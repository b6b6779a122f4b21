"""Model configs and the serving model."""
from repro_torch.models.config import HADConfig, ModelConfig  # noqa: F401
