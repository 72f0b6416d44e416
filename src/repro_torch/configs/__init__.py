"""Model configurations the port serves: ConvNet specs (`convnets`) and the
language-model architectures (`base`, `archs`)."""

from repro_torch.configs.base import (
    ArchConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
    get_arch,
    list_archs,
)

__all__ = [
    "ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "get_arch", "list_archs",
]
