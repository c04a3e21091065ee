"""Gradient codecs of the port: dense, ATOMO SVD, QSGD and TernGrad."""

from typing import Optional

from atomo_tpu_torch.codecs.base import (  # noqa: F401
    Codec,
    CodecStats,
    codec_subset,
    decode_mean_tree,
    decode_tree,
    encode_leaf_subset,
    encode_tree,
    encode_tree_streamed,
    leaf_codec,
    payload_nbytes,
    stack_leaves,
    tree_nbytes,
)
from atomo_tpu_torch.codecs.dense import DenseCodec, DensePayload  # noqa: F401
from atomo_tpu_torch.codecs.indicators import (  # noqa: F401
    l1_indicator,
    nuclear_indicator,
    spectral_atoms_preferred,
)
from atomo_tpu_torch.codecs.qsgd import QsgdCodec, QsgdPayload, terngrad  # noqa: F401
from atomo_tpu_torch.codecs.svd import (  # noqa: F401
    SvdCodec,
    SvdMaskedPayload,
    SvdPayload,
    bernoulli_probs,
    resize_to_2d,
    undo_resize,
)


def get_codec(
    name: str,
    *,
    svd_rank: int = 3,
    quantization_level: int = 2,
    bucket_size: int = 512,
    sample: str = "fixed_k",
    algorithm: str = "auto",
    wire_dtype: str = "float32",
    use_kernel: Optional[bool] = None,
    pack_kernel: Optional[bool] = None,
):
    """Build a codec by CLI name, as ``atomo_tpu.codecs.get_codec``."""
    name = name.lower()
    if name in ("sgd", "dense", "none"):
        return DenseCodec()
    if name == "svd":
        return SvdCodec(rank=svd_rank, sample=sample, algorithm=algorithm,
                        wire_dtype=wire_dtype)
    if name == "svd_budget":  # svd with the Bernoulli budget sampler
        return SvdCodec(rank=svd_rank, sample="bernoulli_budget",
                        algorithm=algorithm, wire_dtype=wire_dtype)
    if name == "qsgd":
        return QsgdCodec(bits=quantization_level, bucket_size=bucket_size,
                         use_kernel=use_kernel, pack_kernel=pack_kernel)
    if name == "terngrad":
        return terngrad(bucket_size=bucket_size, use_kernel=use_kernel,
                        pack_kernel=pack_kernel)
    raise ValueError(
        f"unknown codec {name!r}; expected one of sgd|svd|svd_budget|qsgd|terngrad"
    )
