"""Hand-written CUDA kernels for Hopper (built with nvcc at first use).

fused_tile -- the parametric gather -> GEMM -> scatter tile kernel that
              carries every L3-fused transformed convolution
"""
