"""Diffusion training on one device: the port of ``diffpir_tpu/train``."""

from diffpir_tpu_torch.train.loop import TrainConfig, TrainState, Trainer, dryrun_train_step

__all__ = ["TrainConfig", "TrainState", "Trainer", "dryrun_train_step"]
