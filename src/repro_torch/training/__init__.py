"""Training: optimizers, the train step and loop, checkpoints
(counterpart of ``repro.training``)."""
from repro_torch.training.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.optimizer import (adafactor_init, adafactor_update,
                                            adamw_init, adamw_update,
                                            make_optimizer)
from repro_torch.training.train_loop import make_train_step, train_loop
