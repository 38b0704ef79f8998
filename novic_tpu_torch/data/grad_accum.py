"""Gradient accumulation bookkeeping (the port's copy of
novic_tpu.data.grad_accum; ref embedding_dataset.py:198-273).

Each training epoch is cut to whole meta-batches of `accum_size` loader
batches (drop_last=True): the training step splits a meta-batch back into its
microbatches and scales each microbatch's mean loss by 1 / accum_size
(train/step.py), so a trailing incomplete meta-batch is dropped rather than
rescaled. With drop_last=False (action=test_data_loader) the epoch keeps its
trailing batches, and accum_loss gives the scaling that makes a trailing
incomplete meta-batch's gradient its samples' mean.
"""

from __future__ import annotations

import itertools
from typing import Iterable

from novic_tpu_torch.data.config import LoaderInfo
from novic_tpu_torch.utils.logger import log


class GradAccum:

    def __init__(self, loader, loader_info: LoaderInfo, accum_size: int, drop_last: bool = True):
        if accum_size < 1:
            raise ValueError(f"Accumulation size below 1: {accum_size}")
        assert loader_info.epoch_batches == len(loader)
        self.raw_loader = loader
        self.raw_epoch_batches = loader_info.epoch_batches
        self.accum_size = accum_size
        self.drop_last = drop_last
        self.batch_size = loader_info.batch_size
        self.complete_steps = loader_info.complete_batches // accum_size
        self.complete_batches = self.complete_steps * accum_size
        self.complete_samples = self.complete_batches * self.batch_size
        if drop_last:
            self.loader_batches = self.complete_batches
            self.loader_samples = self.complete_samples
        else:
            self.loader_batches = loader_info.epoch_batches
            self.loader_samples = loader_info.epoch_samples
        self.incomplete_samples = self.loader_samples - self.complete_samples
        self.incomplete_step = self.incomplete_samples > 0
        self.batch_num = 0
        log.info(f"Gradient accumulation factor {accum_size} results in {self.complete_steps}"
                 f"+{int(self.incomplete_step)} meta-batches of size "
                 f"{self.batch_size * accum_size}+{self.incomplete_samples}")

    def loader(self) -> Iterable:
        """Re-iterable epoch loader. It must survive several `for` passes: the
        training loop iterates it once per epoch, and a one-shot iterator would
        end training silently at the first epoch whose batch count is not a
        multiple of accum_size."""
        ga = self

        class _EpochLoader:
            def __iter__(self):
                ga.batch_num = 0
                if ga.loader_batches < ga.raw_epoch_batches:
                    return iter(itertools.islice(ga.raw_loader, ga.loader_batches))
                return iter(ga.raw_loader)

            def __len__(self):
                return ga.loader_batches

        return _EpochLoader()

    def accum_loss(self, mean_batch_loss, num_in_batch: int):
        """Scale a batch's mean loss for accumulation → (scaled loss, whether an
        optimizer step follows this batch)."""
        self.batch_num += 1
        if self.batch_num <= self.complete_batches:
            scaled = mean_batch_loss / self.accum_size
        else:
            scaled = mean_batch_loss * (num_in_batch / self.incomplete_samples)
        optimizer_step = (self.batch_num % self.accum_size == 0
                          or self.batch_num == self.raw_epoch_batches)
        return scaled, optimizer_step
