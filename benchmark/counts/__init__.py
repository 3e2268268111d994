"""The benchmark's own arithmetic: the operations and bytes of each model
stage and of each hand-written kernel launch, from the shapes of a
configuration. Operations count the products of convolutions and matrix
products (2 per multiply-add); elementwise work, norms and pooling are
left out, as ``torch.utils.flop_counter`` leaves them out. Nothing here
reads the program: the rooflines and mfu divide by these numbers.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).
"""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
