"""PerLeafCodec: an allocation's per-layer knobs (SVD ranks or QSGD bit
widths) as a codec wrapper.

Counterpart of ``atomo_tpu/budget/codec.py``. The tree walkers of
:mod:`atomo_tpu_torch.codecs.base` (``encode_leaf_subset``, ``decode_tree``,
``decode_mean_tree``) resolve the codec per leaf through
``codecs.base.leaf_codec``; this wrapper is what they resolve:

* ``codec_for(i)`` returns a frozen codec whose knob is a Python int, so
  every payload's size is known from the leaf's shape alone;
* a leaf's seed is ``fold_in(key, i)`` of its global index, as before: the
  wrapper only changes which codec consumes it. At uniform knobs the
  resolved codecs compare equal to the base codec, the walkers see one group
  and the payloads equal the plain codec's bit for bit;
* ``subset`` re-indexes for a walker over a partial leaf list with local
  indices (``codecs.base.codec_subset``).

It has no whole-tensor ``encode`` or ``decode`` of its own: a per-leaf codec
called without a leaf index is a fault, and an ``AttributeError`` at the call
site says so where a default knob would hide it.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class PerLeafCodec:
    """A base codec and one resolved (frozen) codec per canonical leaf."""

    base: Any
    codecs: tuple  # per-leaf frozen codec instances, canonical order
    name: str = "svd+ab"

    @property
    def n_leaves(self) -> int:
        return len(self.codecs)

    @property
    def ks(self) -> tuple:
        return tuple(int(getattr(c, "rank", None) or c.bits) for c in self.codecs)

    def codec_for(self, i: int):
        """The codec of GLOBAL leaf index ``i``."""
        if not 0 <= int(i) < len(self.codecs):
            raise IndexError(
                f"PerLeafCodec covers {len(self.codecs)} leaves but leaf "
                f"{i} was requested — the allocation and the gradient "
                "tree must come from the same model"
            )
        return self.codecs[int(i)]

    def subset(self, idxs: tuple) -> "PerLeafCodec":
        """The wrapper of a sub-list of leaves: local position j resolves to
        global leaf ``idxs[j]``."""
        return PerLeafCodec(base=self.base, codecs=tuple(self.codecs[int(i)] for i in idxs),
                            name=self.name)


def budgeted_codec(base, ks) -> PerLeafCodec:
    """``base`` with an allocation's per-leaf knobs (canonical order): SVD
    ranks or QSGD bit widths, by the field the base codec carries
    (:func:`~atomo_tpu_torch.budget.allocator.knob_name`)."""
    from atomo_tpu_torch.budget.allocator import knob_name

    knob = knob_name(base)
    return PerLeafCodec(
        base=base,
        codecs=tuple(dataclasses.replace(base, **{knob: int(k)}) for k in ks),
        name=f"{getattr(base, 'name', 'codec')}+ab",
    )
