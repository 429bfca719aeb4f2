from .classifier import ImageClassifier, accuracy, cross_entropy  # noqa: F401
from .config import Config, load_config, save_config  # noqa: F401
from .optim import (  # noqa: F401
    LARS,
    SGD,
    Adam,
    GroupedOptimizer,
    MultiSteps,
    RMSprop,
    make_optimizer,
    param_group,
    sgd_with_param_groups,
    warmup_cosine_schedule,
)
from .step import (  # noqa: F401
    DeviceStepDraws,
    StepDraws,
    TrainState,
    make_device_data_train_step,
    make_eval_accumulate_step,
    make_eval_step,
    make_train_step,
)
