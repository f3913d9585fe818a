"""The LM stack's models, every family of `repro.models`: dense, MoE,
SSM, hybrid, enc-dec and VLM (`registry.build`)."""
from repro_torch.models.registry import ModelBundle, build

__all__ = ["ModelBundle", "build"]
