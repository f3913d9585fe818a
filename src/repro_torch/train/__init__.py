"""The training step (the counterpart of `repro.train`)."""
from repro_torch.train.step import make_train_step, make_train_step_compressed

__all__ = ["make_train_step", "make_train_step_compressed"]
