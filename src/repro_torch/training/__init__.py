"""The port's trainer (:mod:`repro.training`'s exports)."""

from repro_torch.training.trainer import (
    TrainState, make_train_step, train_state_init,
)

__all__ = ["TrainState", "make_train_step", "train_state_init"]
