from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.training.train_step import TrainConfig, make_train_step  # noqa: F401
