"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin."""

from atomo_tpu_torch.ops.qsgd_kernels import (  # noqa: F401
    launch_counts,
    pack_bucketed,
    quantize_pack,
    reset_launch_counts,
    unpack_bucketed,
    unpack_dequantize,
)
