"""Model configurations the port serves: ConvNet specs (`convnets`) and the
language-model architectures (`base`, `archs`) with the dry run's shape
cells (`SHAPES`)."""

from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    cell_is_defined,
    get_arch,
    list_archs,
)

__all__ = [
    "ArchConfig", "ShapeConfig", "MoEConfig", "MLAConfig", "SSMConfig",
    "SHAPES", "get_arch", "list_archs", "cell_is_defined",
]
