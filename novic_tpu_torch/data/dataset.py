"""Embedding dataset base class (the port's copy of novic_tpu.data.dataset).

Mirrors the reference EmbeddingDataset contract (reference
embedding_dataset.py:60-195): targets tuple with leading invalid entries,
target-config translation, data-config negotiation, and a create_loader()
contract returning standardized batches
(embed BxF, target BxC|BxMxC|MxBxC, mask, weight).

Batches are numpy arrays produced on the host by a prefetching loader
(novic_tpu_torch.data.loader), which pins them and copies them to the device
without blocking — there is no per-sample collate and no worker fork (the
cache Dataset already yields whole batches zero-copy from the memory map).
"""

from __future__ import annotations

import collections
import contextlib
from typing import ContextManager, Optional

from novic_tpu_torch.data.config import DataConfig, resolve_data_config
from novic_tpu_torch.text.target import TargetConfig
from novic_tpu_torch.utils.logger import log


class EmbeddingDataset:
    """Base dataset of embeddings + (optional) target tokenizations."""

    def __init__(
        self,
        target_config: Optional[TargetConfig],       # Target tokenization spec (required if use_targets)
        nominal_data_config: DataConfig,             # Preferred data configuration of the dataset
        strict_data_config_fields: set[str],         # Non-negotiable DataConfig fields
        num_items: int,                              # Items (= batches for cache datasets)
        num_embeds: Optional[int] = None,            # Samples (>= num_items)
        targets: Optional[tuple[str, ...]] = None,   # All target nouns incl. leading invalid
        num_invalid_targets: int = 0,                # Leading placeholder targets (e.g. '')
        use_targets: bool = True,
    ):
        self.target_config = target_config
        self.nominal_data_config = nominal_data_config
        self.strict_data_config_fields = strict_data_config_fields
        self.num_items = num_items
        self.num_embeds = num_embeds if num_embeds is not None else num_items
        self.targets = targets
        self.have_targets = bool(self.targets)
        self.num_invalid_targets = 0 if not self.have_targets else num_invalid_targets
        self.num_valid_targets = 0 if not self.have_targets else len(self.targets) - self.num_invalid_targets

        self.use_targets = use_targets
        if self.num_items < 1 or self.num_embeds < 1 or self.num_items > self.num_embeds:
            raise ValueError("Embedding dataset is empty or malformed")
        if self.have_targets and (self.num_valid_targets > len(self.targets) or self.num_valid_targets < 1):
            raise ValueError(f"Number of valid targets must be positive: {self.num_valid_targets}")
        if self.use_targets:
            if not self.have_targets:
                raise ValueError("Dataset carries no targets to use")
            counts = collections.Counter(self.targets)
            dups = sorted(item for item in counts.items() if item[1] > (1 if item[0] else 2))
            if dups:
                raise ValueError(f"There are duplicates in the dataset: {dups}")

        self.translation: Optional[TargetConfig] = None
        self.data_config: Optional[DataConfig] = None

    def __len__(self) -> int:
        return self.num_items

    def set_translation(self, target_config: Optional[TargetConfig]):
        """Retarget token IDs to a different model's TargetConfig
        (ref embedding_dataset.py:105-120)."""
        if target_config is not None:
            if not self.use_targets:
                raise ValueError("Cannot set a non-None translation for a dataset without targets")
            own = self.target_config
            for field in ("fixed_token_length", "token_length", "use_masks"):
                if getattr(target_config, field) != getattr(own, field):
                    log.warning(
                        f"Translation target config {field} mismatch: Dataset "
                        f"{getattr(own, field)} vs Translation {getattr(target_config, field)} "
                        f"(returned data will respect the former)")
            if target_config.compact_ids != own.compact_ids:
                raise ValueError("A translation must preserve tokenization compactness")
            if (target_config.start_token_id is None) != (own.start_token_id is None) or \
               (target_config.end_token_id is None) != (own.end_token_id is None):
                raise ValueError("A translation must preserve start/end token presence")
            target_config = target_config.replace(
                fixed_token_length=own.fixed_token_length, token_length=own.token_length,
                use_masks=own.use_masks)
        self.translation = target_config

    def resolve_data_config(self, **data_kwargs) -> DataConfig:
        return resolve_data_config(self.nominal_data_config, self.strict_data_config_fields,
                                   self.use_targets, **data_kwargs)

    def configure_data(self, data_config: DataConfig):
        self.data_config = data_config
        if not data_config.use_weights and self.nominal_data_config.use_weights:
            log.warning("Information is being lost: data configuration ignores non-trivial weights")
        if data_config.multi_length < self.nominal_data_config.multi_length:
            log.warning(
                f"Information is being lost: reduced multi-target length "
                f"({data_config.multi_length} < {self.nominal_data_config.multi_length})")
        if self.use_targets and self.target_config is not None and not self.target_config.use_masks \
                and not data_config.use_weights and not data_config.full_targets:
            raise RuntimeError(
                "When using non-full targets without padding masks and without weights, there "
                "is no robust way of telling which targets are supposed to be ignored")

    def loaded(self) -> ContextManager:
        """Context manager covering all __getitem__ access (e.g. holds the mmap)."""
        return contextlib.nullcontext()

    def __getitem__(self, index):
        raise NotImplementedError

    def create_loader(self, batch_size: int, training: bool, *, num_threads: int = 1,
                      prefetch: int = 2, device=None, seed: Optional[int] = None):
        """Return (loader, LoaderInfo); loader iterates standardized batches."""
        raise NotImplementedError
