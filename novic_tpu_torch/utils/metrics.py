"""Run metrics logging to local JSON lines, with an optional wandb passthrough
(the counterpart of novic_tpu.utils.metrics).

MetricsLogger writes one {"_step", "_time", ...} object per line to
<run_dir>/metrics.jsonl and the run's config to <run_dir>/config.json, and
forwards log / log_table / finish to wandb when use_wandb is set and the
package imports. Where wandb is not installed it warns and logs locally only,
as the JAX package's logger does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

from novic_tpu_torch.utils.logger import log as _console


class MetricsLogger:

    def __init__(self, run_dir: Optional[str] = None, use_wandb: bool = False,
                 project: str = "novic_tpu", config: Optional[dict] = None,
                 name: Optional[str] = None, wandb_kwargs: Optional[dict] = None):
        self.run_dir = run_dir
        self._file = None
        self._step = 0
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._file = open(os.path.join(run_dir, "metrics.jsonl"), "a")
            if config:
                with open(os.path.join(run_dir, "config.json"), "w") as f:
                    json.dump(config, f, indent=2, default=str)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                _console.warning("wandb requested but not installed => local JSONL only")
            else:
                self._wandb = wandb
                # entity/group/name/tags/job_type passthrough; falsy values are
                # dropped so empty config defaults leave wandb's own; name= wins
                kw = {k: v for k, v in (wandb_kwargs or {}).items() if v}
                if name:
                    kw["name"] = name
                wandb.init(project=project, config=config, **kw)

    def log(self, metrics: dict[str, Any]):
        self._step += 1
        if self._file:
            record = {"_step": self._step, "_time": time.time()}
            record.update({k: v for k, v in metrics.items() if _jsonable(v)})
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(metrics)

    def log_table(self, key: str, columns: list[str], rows: list[list]):
        if self._file:
            self._file.write(json.dumps({"_step": self._step, "_table": key,
                                         "columns": columns, "rows": rows}, default=str) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log({key: self._wandb.Table(columns=columns, data=rows)})

    def finish(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._wandb:
            self._wandb.finish()


def _jsonable(v) -> bool:
    return isinstance(v, (int, float, str, bool, type(None)))
