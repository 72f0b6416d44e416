"""Hand-written CUDA kernels for Hopper (built with nvcc at first use,
through `_build`).

fused_tile      -- the parametric gather -> GEMM -> scatter tile kernel that
                   carries every L3-fused transformed convolution
conv1d_fused    -- depthwise causal conv1d + bias + SiLU (Mamba's short conv,
                   the registry's temporal `conv1d_fused` algorithm)
flash_attention -- forward attention with online softmax, causal and
                   sliding-window band skipping, GQA
decode_mlp      -- the weight-stationary fused SwiGLU MLP of a decode step
"""
