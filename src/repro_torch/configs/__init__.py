"""Architecture configurations (data only), as in ``repro.configs``."""
from repro_torch.configs.base import (ArchConfig, MoEConfig, ShapeConfig,
                                      SHAPES, shape_applicable)
from repro_torch.configs.registry import ARCH_IDS, get_config, train_schedule

__all__ = ["ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES",
           "shape_applicable", "ARCH_IDS", "get_config", "train_schedule"]
