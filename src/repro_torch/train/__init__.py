"""Training loop substrate of the port: step factories, the train state's
checkpoint layout and the fault-tolerant Trainer."""
from repro_torch.train.step import (init_train_state, make_decode_step, make_prefill_step,
                                    make_train_step, restore_train_state, train_state,
                                    train_state_tree)
from repro_torch.train.trainer import SimulatedFailure, Trainer

__all__ = ["make_train_step", "init_train_state", "train_state", "train_state_tree",
           "restore_train_state", "make_prefill_step", "make_decode_step", "Trainer",
           "SimulatedFailure"]
