"""Data layer of the port: datasets (disk or synthetic) and batching."""

from atomo_tpu_torch.data.datasets import (  # noqa: F401
    SPECS,
    ArrayDataset,
    DatasetSpec,
    canonical_name,
    load_dataset,
    synthetic_dataset,
)
from atomo_tpu_torch.data.pipeline import (  # noqa: F401
    BatchIterator,
    BlockStream,
    SuperstepFeed,
    augment_batch,
    block_to_device,
    to_device,
)
from atomo_tpu_torch.data.zipf import zipf_dataset, zipf_probs, zipf_spec  # noqa: F401
