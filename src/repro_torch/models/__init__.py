"""The LM stack's models: the dense family so far (`registry.build`)."""
from repro_torch.models.registry import ModelBundle, build

__all__ = ["ModelBundle", "build"]
