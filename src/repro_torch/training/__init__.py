from repro_torch.training.data import PipelineState, SyntheticLM, TrajectoryLM
from repro_torch.training.optimizer import (adafactor_init, adafactor_update,
                                            adamw_init, adamw_update,
                                            make_optimizer)
from repro_torch.training.schedules import cosine, wsd
from repro_torch.training.train import (loss_and_grads, loss_fn,
                                        make_train_step, require_trainable)

__all__ = ["PipelineState", "SyntheticLM", "TrajectoryLM", "adafactor_init",
           "adafactor_update", "adamw_init", "adamw_update", "make_optimizer",
           "cosine", "wsd", "loss_and_grads", "loss_fn", "make_train_step",
           "require_trainable"]
