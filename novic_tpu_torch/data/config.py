"""Dataset data-shape configuration and loader metadata (the port's copy of
novic_tpu.data.config).

Reimplements the reference's DataConfig / LoaderInfo contracts
(reference embedding_dataset.py:19-57) and the three-way data-config
negotiation between model, config, and dataset (:122-149).

Invariant (ref embedding_dataset.py:20): per embedding, targets are ordered
strictly: non-fully-padded non-zero-weighted → non-fully-padded zero-weighted
→ fully-padded zero-weighted; the first target is never fully padded or
zero-weighted; weights are non-negative and descending.
"""

from __future__ import annotations

import dataclasses
from typing import Union


@dataclasses.dataclass(frozen=True)
class DataConfig:
    use_weights: bool         # Include per-target weight arrays
    unit_weights: bool        # If use_weights: weights per embedding sum to 1
    multi_target: bool        # Multiple targets per embedding (adds M dimension)
    multi_first: bool         # If multi_target: M dimension before batch (MxB) vs after (BxM)
    full_targets: bool        # If multi_target: every embedding has all M targets non-fully-padded
    fixed_multi_length: bool  # If multi_target: M is always exactly multi_length
    multi_length: int         # Maximum number of targets per embedding

    @staticmethod
    def create(data_config_dict: dict[str, Union[bool, int]], use_targets: bool = True) -> "DataConfig":
        d = dict(data_config_dict)
        if not use_targets:
            d.update(use_weights=False, multi_target=False)
        if not d["use_weights"]:
            d.update(unit_weights=True)
        if not d["multi_target"]:
            d.update(multi_first=False, full_targets=True, fixed_multi_length=True, multi_length=1)
        data_config = DataConfig(**d)
        if data_config.multi_length < 1:
            raise ValueError(f"Multi-target count must be positive, got {data_config.multi_length}")
        return data_config

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class LoaderInfo:
    """Loader bookkeeping (ref embedding_dataset.py:45-57)."""
    num_workers: int
    prefetch_factor: int
    pin_memory: bool
    on_device: bool
    batch_size: int
    batch_size_last: int
    complete_batches: int
    incomplete_batch: bool
    epoch_batches: int
    epoch_samples: int
    available_samples: int


def resolve_data_config(
    nominal: DataConfig,
    strict_fields: set[str],
    use_targets: bool,
    **data_kwargs,
) -> DataConfig:
    """Three-way negotiation: requested kwargs vs nominal config vs strict fields
    (ref embedding_dataset.py:122-149). None kwargs = don't care."""
    nominal_dict = dataclasses.asdict(nominal)
    d = {}
    for field_name, nominal_value in nominal_dict.items():
        kwarg_value = data_kwargs.pop(field_name, None)
        d[field_name] = kwarg_value if kwarg_value is not None else nominal_value
    if data_kwargs:
        raise ValueError(f"Unrecognised data config fields: {sorted(data_kwargs.keys())}")

    remaining = set(strict_fields)
    for field_name in strict_fields:
        if d[field_name] == nominal_dict[field_name]:
            remaining.discard(field_name)

    data_config = DataConfig.create(data_config_dict=d, use_targets=use_targets)
    if data_config.multi_length > nominal.multi_length:
        raise ValueError(
            f"This embedding dataset does not support a number of multi-targets above "
            f"{nominal.multi_length}: {data_config.multi_length}")

    for field_name in strict_fields:
        if getattr(data_config, field_name) == nominal_dict[field_name]:
            remaining.discard(field_name)
    if remaining:
        raise ValueError(
            f"Incompatibility between embedding dataset and requested data config in fields: "
            f"{sorted(remaining)}")
    return data_config
