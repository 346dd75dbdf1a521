"""Weakly-supervised training (port of ``tpuseg/train``): the step
(``step.py``), validation (``val.py``), data parallelism over processes
(``dp.py``) and the loop (``loop.py``)."""

from tpuseg_torch.train.dp import (make_data_mesh, make_dp_train_step,
                                   shard_batch)
from tpuseg_torch.train.loop import train
from tpuseg_torch.train.step import (AdamW, TrainState, create_train_state,
                                     loss_fn, lr_schedule, make_train_step,
                                     prepare_batch)
from tpuseg_torch.train.val import make_val_eval, split_volumes

__all__ = ["AdamW", "TrainState", "create_train_state", "loss_fn",
           "lr_schedule", "make_data_mesh", "make_dp_train_step",
           "make_train_step", "make_val_eval", "prepare_batch", "shard_batch",
           "split_volumes", "train"]
