"""Run metrics logging to local JSON lines (the counterpart of novic_tpu.utils.metrics).

MetricsLogger writes one {"_step", "_time", ...} object per line to
<run_dir>/metrics.jsonl and the run's config to <run_dir>/config.json. The
wandb passthrough of the JAX package is not ported: use_wandb=True raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricsLogger:

    def __init__(self, run_dir: Optional[str] = None, use_wandb: bool = False,
                 config: Optional[dict] = None):
        if use_wandb:
            raise NotImplementedError("use_wandb=true is not ported yet (metrics go to metrics.jsonl)")
        self.run_dir = run_dir
        self._file = None
        self._step = 0
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._file = open(os.path.join(run_dir, "metrics.jsonl"), "a")
            if config:
                with open(os.path.join(run_dir, "config.json"), "w") as f:
                    json.dump(config, f, indent=2, default=str)

    def log(self, metrics: dict[str, Any]):
        self._step += 1
        if self._file:
            record = {"_step": self._step, "_time": time.time()}
            record.update({k: v for k, v in metrics.items() if _jsonable(v)})
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def finish(self):
        if self._file:
            self._file.close()
            self._file = None


def _jsonable(v) -> bool:
    return isinstance(v, (int, float, str, bool, type(None)))
