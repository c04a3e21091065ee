"""The LM layouts' mesh grammar (``spec``) and model-axis collectives
(``collectives``) over ``torch.distributed`` process groups, the
partitioned weight update (``update``: ZeRO-1 and the sharded update) and
the live reshards (``reshard``)."""

from atomo_tpu_torch.mesh.spec import (  # noqa: F401
    LAYOUT_MODEL_AXES,
    MODEL_AXES,
    MeshSpec,
    ProcessMesh,
)
