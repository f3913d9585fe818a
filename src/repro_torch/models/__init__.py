"""The LM stack's models, every family of `repro.models`: dense, MoE,
SSM, hybrid, enc-dec and VLM (`registry.build`)."""
from repro_torch.models.registry import (ModelBundle, batch_logical_specs,
                                         build, input_specs)

__all__ = ["ModelBundle", "batch_logical_specs", "build", "input_specs"]
