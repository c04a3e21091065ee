"""Gradient codecs of the port: dense, QSGD and TernGrad."""

from typing import Optional

from atomo_tpu_torch.codecs.base import (  # noqa: F401
    Codec,
    CodecStats,
    decode_tree,
    encode_tree,
    payload_nbytes,
    stack_leaves,
)
from atomo_tpu_torch.codecs.dense import DenseCodec, DensePayload  # noqa: F401
from atomo_tpu_torch.codecs.qsgd import QsgdCodec, QsgdPayload, terngrad  # noqa: F401


def get_codec(
    name: str,
    *,
    quantization_level: int = 2,
    bucket_size: int = 512,
    use_kernel: Optional[bool] = None,
    pack_kernel: Optional[bool] = None,
):
    """Build a codec by CLI name (the ported subset of the JAX registry)."""
    name = name.lower()
    if name in ("sgd", "dense", "none"):
        return DenseCodec()
    if name == "qsgd":
        return QsgdCodec(bits=quantization_level, bucket_size=bucket_size,
                         use_kernel=use_kernel, pack_kernel=pack_kernel)
    if name == "terngrad":
        return terngrad(bucket_size=bucket_size, use_kernel=use_kernel,
                        pack_kernel=pack_kernel)
    raise ValueError(
        f"unknown codec {name!r} for the port; expected one of sgd|qsgd|terngrad "
        "(svd comes with a later slice)"
    )
