"""The LM stack's models: the dense and MoE families (`registry.build`)."""
from repro_torch.models.registry import ModelBundle, build

__all__ = ["ModelBundle", "build"]
