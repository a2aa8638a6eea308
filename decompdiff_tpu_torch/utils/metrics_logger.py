"""Metrics logging: JSONL always, TensorBoard when available (port of
decompdiff_tpu/utils/metrics_logger.py; role: ref utils/train.py:73-124,
log_losses + ValidationLossTape feeding a SummaryWriter).

Every scalar goes to <run>/metrics.jsonl; when torch.utils.tensorboard (or
tensorboardX) can be imported and built, scalars are mirrored there too.
"""

from __future__ import annotations

import json
import os
import time


def _try_tb(logdir):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logdir)
    except Exception:
        pass
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(logdir)
    except Exception:
        return None


class MetricsLogger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, 'metrics.jsonl'), 'a')
        self._tb = _try_tb(logdir)

    def log(self, step: int, tag: str, values: dict):
        rec = {'step': int(step), 'tag': tag, 'time': time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + '\n')
        self._f.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f'{tag}/{k}', float(v), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class ValidationLossTape:
    """Weighted-mean accumulator (ref utils/train.py:97-124)."""

    def __init__(self):
        self.totals = {}
        self.n = 0

    def update(self, losses: dict, weight: int = 1):
        for k, v in losses.items():
            self.totals[k] = self.totals.get(k, 0.0) + float(v) * weight
        self.n += weight

    def averages(self) -> dict:
        return {k: v / max(self.n, 1) for k, v in self.totals.items()}
