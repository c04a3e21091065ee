"""The elastic world's survivor-exact mean (``atomo_tpu/elastic/``).

Only :mod:`.shrink`'s three device functions are ported so far: the
operator the quorum step and ``survivor_exact=`` run. The membership
layer, the coordinator and ``track_ok_bits`` are not ported yet.
"""

from atomo_tpu_torch.elastic.shrink import mask_absent, roster_fold_sum, survivor_decode_mean

__all__ = ["mask_absent", "roster_fold_sum", "survivor_decode_mean"]
