from repro_torch.kernels.decode_mlp.ops import decode_mlp
from repro_torch.kernels.decode_mlp.ref import decode_mlp_ref

__all__ = ["decode_mlp", "decode_mlp_ref"]
