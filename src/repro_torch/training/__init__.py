"""The train step and the fault-tolerant training loop (counterpart of
`repro.training`)."""
from .trainer import (StepMetrics, Trainer, TrainState, Watchdog,
                      make_train_step)

__all__ = ["StepMetrics", "Trainer", "TrainState", "Watchdog",
           "make_train_step"]
