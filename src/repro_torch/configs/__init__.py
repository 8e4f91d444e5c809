from .base import (
    ARCH_IDS, active_param_count, all_configs, get_config, param_count, reduced_config,
)

__all__ = [
    "ARCH_IDS", "active_param_count", "all_configs", "get_config", "param_count",
    "reduced_config",
]
