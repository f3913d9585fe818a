from repro_torch.configs.base import (ARCH_IDS, LONG_CONTEXT_ARCHS, SHAPES,
                                      ModelConfig, ShapeConfig, cells,
                                      get_config, reduced)

__all__ = ["ARCH_IDS", "LONG_CONTEXT_ARCHS", "SHAPES", "ModelConfig",
           "ShapeConfig", "cells", "get_config", "reduced"]
