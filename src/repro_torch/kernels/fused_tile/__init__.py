from repro_torch.kernels.fused_tile.blocks import BlockConfig
from repro_torch.kernels.fused_tile.kernel import cost, fused_tile_call
from repro_torch.kernels.fused_tile.matrix import (
    matrix_tile_conv,
    staged_matrix_fns,
)
from repro_torch.kernels.fused_tile.ops import (
    UnsupportedSpec,
    conv2d_fused_tile,
    engine_supported,
)

__all__ = [
    "cost",
    "BlockConfig",
    "UnsupportedSpec",
    "conv2d_fused_tile",
    "engine_supported",
    "fused_tile_call",
    "matrix_tile_conv",
    "staged_matrix_fns",
]
