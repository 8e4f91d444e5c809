from .base import (
    ARCH_IDS, SHAPES, ShapeCell, active_param_count, all_configs, get_config, param_count,
    reduced_config, shape_cells,
)

__all__ = [
    "ARCH_IDS", "SHAPES", "ShapeCell", "active_param_count", "all_configs", "get_config",
    "param_count", "reduced_config", "shape_cells",
]
