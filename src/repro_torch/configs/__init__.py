from repro_torch.configs.registry import (
    ARCH_NAMES,
    PORTED,
    SHAPES,
    ShapeSpec,
    get_config,
    input_specs,
    smoke_config,
    supports,
)

__all__ = ["ARCH_NAMES", "PORTED", "SHAPES", "ShapeSpec", "get_config",
           "input_specs", "smoke_config", "supports"]
