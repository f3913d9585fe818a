"""Optimizers, schedules and the majority-vote signum step (the
counterpart of `repro.optim`)."""
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          clip_by_global_norm, get_optimizer,
                                          sgd)
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.optim.signum import (majority_allreduce, pack_tree, signum,
                                      unpack_tree)

__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "get_optimizer", "sgd", "constant", "warmup_cosine",
           "majority_allreduce", "pack_tree", "signum", "unpack_tree"]
