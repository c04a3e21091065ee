"""Training runtime of the port: single-device trainer and momentum SGD."""

from atomo_tpu_torch.training.optim import (  # noqa: F401
    Sgd,
    SgdState,
    make_optimizer,
    stepwise_shrink,
)
from atomo_tpu_torch.training.trainer import (  # noqa: F401
    TrainState,
    create_state,
    evaluate,
    make_train_step,
    train_loop,
)
