"""Gradient accumulation bookkeeping (the port's copy of
novic_tpu.data.grad_accum; ref embedding_dataset.py:198-273).

Each epoch is cut to whole meta-batches of `accum_size` loader batches: the
training step splits a meta-batch back into its microbatches and scales each
microbatch's mean loss by 1 / accum_size (train/step.py), so a trailing
incomplete meta-batch is dropped rather than rescaled.
"""

from __future__ import annotations

import itertools
from typing import Iterable

from novic_tpu_torch.data.config import LoaderInfo
from novic_tpu_torch.utils.logger import log


class GradAccum:

    def __init__(self, loader, loader_info: LoaderInfo, accum_size: int):
        if accum_size < 1:
            raise ValueError(f"Accumulation size below 1: {accum_size}")
        assert loader_info.epoch_batches == len(loader)
        self.raw_loader = loader
        self.raw_epoch_batches = loader_info.epoch_batches
        self.accum_size = accum_size
        self.complete_steps = loader_info.complete_batches // accum_size
        self.loader_batches = self.complete_steps * accum_size
        log.info(f"Gradient accumulation factor {accum_size} results in {self.complete_steps} "
                 f"meta-batches of size {loader_info.batch_size * accum_size}")

    def loader(self) -> Iterable:
        """Re-iterable epoch loader. It must survive several `for` passes: the
        training loop iterates it once per epoch, and a one-shot iterator would
        end training silently at the first epoch whose batch count is not a
        multiple of accum_size."""
        ga = self

        class _EpochLoader:
            def __iter__(self):
                if ga.loader_batches < ga.raw_epoch_batches:
                    return iter(itertools.islice(ga.raw_loader, ga.loader_batches))
                return iter(ga.raw_loader)

            def __len__(self):
                return ga.loader_batches

        return _EpochLoader()
