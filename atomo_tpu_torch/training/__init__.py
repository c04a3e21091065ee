"""Training runtime of the port: the trainers, SGD and Adam, checkpoints and
the checkpoint-polling evaluator."""

from atomo_tpu_torch.training.optim import (  # noqa: F401
    Adam,
    AdamState,
    Optimizer,
    Sgd,
    SgdState,
    make_optimizer,
    stepwise_shrink,
)
from atomo_tpu_torch.training.trainer import (  # noqa: F401
    TrainState,
    create_state,
    distributed_train_loop,
    evaluate,
    make_train_step,
    train_loop,
)
