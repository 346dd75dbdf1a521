"""Weakly-supervised training (port of ``tpuseg/train``): the step
(``step.py``), validation (``val.py``) and the single-device loop
(``loop.py``)."""

from tpuseg_torch.train.loop import train
from tpuseg_torch.train.step import (AdamW, TrainState, create_train_state,
                                     loss_fn, lr_schedule, make_train_step,
                                     prepare_batch)
from tpuseg_torch.train.val import make_val_eval, split_volumes

__all__ = ["AdamW", "TrainState", "create_train_state", "loss_fn",
           "lr_schedule", "make_train_step", "make_val_eval",
           "prepare_batch", "split_volumes", "train"]
