from .classifier import ImageClassifier, accuracy, cross_entropy  # noqa: F401
from .optim import (  # noqa: F401
    SGD,
    make_optimizer,
    param_group,
    sgd_with_param_groups,
    warmup_cosine_schedule,
)
from .step import StepDraws, TrainState, make_eval_step, make_train_step  # noqa: F401
