"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin."""

from atomo_tpu_torch.ops import attention_kernels, qsgd_kernels
from atomo_tpu_torch.ops.attention_kernels import (  # noqa: F401
    flash_attention,
    flash_attention_forward,
    flash_attention_plain,
)
from atomo_tpu_torch.ops.qsgd_kernels import (  # noqa: F401
    pack_bucketed,
    quantize_pack,
    unpack_bucketed,
    unpack_dequantize,
)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel since the last reset, by kernel name."""
    return {**qsgd_kernels.launch_counts(), **attention_kernels.launch_counts()}


def reset_launch_counts() -> None:
    qsgd_kernels.reset_launch_counts()
    attention_kernels.reset_launch_counts()
