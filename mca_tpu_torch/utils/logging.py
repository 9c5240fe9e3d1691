"""Step logging and throughput metering, ported from ``mca_tpu/utils/logging.py``.

- :class:`JSONLLogger`: one JSON object per line in
  ``<output_dir>/metrics.jsonl`` (line-buffered), each with ``step``
  and ``time``; mirrored to wandb when the config enables it and the
  package is installed (imported only then).
- :class:`NullLogger`: the stand-in that logs nothing.
- :class:`ThroughputMeter`: tokens/s and ms per step over a sliding
  window of step stamps.
- :func:`trace_context`: the ``torch.profiler`` window of ``trace_dir``,
  re-exported from :mod:`mca_tpu_torch.utils.trace`, the port's tracing.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Any, Dict, Optional

from mca_tpu_torch.utils.trace import trace_context  # noqa: F401  (the callers' import path)

_log = logging.getLogger(__name__)


def _to_scalar(v: Any) -> Any:
    return v.item() if hasattr(v, "item") else v


class NullLogger:
    """A logger that drops every record."""

    wandb_id = None

    def log(self, metrics, step=None):
        pass

    def close(self):
        pass


class JSONLLogger:
    """Append-only JSONL metric log with optional wandb mirroring.

    NaN pair losses (a pair absent from every row of a batch) are
    written as bare ``NaN`` tokens, which ``json.loads`` accepts.
    """

    def __init__(
        self,
        output_dir: str,
        filename: str = "metrics.jsonl",
        wandb_config: Optional[Dict[str, Any]] = None,
    ):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._file = open(self.path, "a", buffering=1)
        self._wandb = None
        if wandb_config:
            try:
                import wandb

                self._wandb = wandb.init(**wandb_config)
            except Exception:  # absent or unreachable: the JSONL log goes on
                _log.warning("wandb mirroring is off", exc_info=True)

    @property
    def wandb_id(self) -> Optional[str]:
        """The wandb run's id (None without mirroring): the preemption
        marker records it so that the restarted run resumes that run."""
        return self._wandb.id if self._wandb is not None else None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        record = {k: _to_scalar(v) for k, v in metrics.items()}
        if step is not None:
            record["step"] = int(step)
        record["time"] = time.time()
        self._file.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "time"}, step=step)

    def close(self):
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()


class ThroughputMeter:
    """Sliding-window tokens/s and step time.

    Each :meth:`step` stamps the host clock once the step has ended;
    the first ``warmup_steps`` steps (kernel builds, allocator warm-up)
    are not stamped, and the rate counts the steps between the first
    and the last stamp of the window.
    """

    def __init__(self, tokens_per_step: int, warmup_steps: int = 2, window: int = 256):
        self.tokens_per_step = tokens_per_step
        self.warmup_steps = warmup_steps
        self._steps = 0
        # (stamp, steps in the burst); stamps 5 ms apart or closer merge
        self._times: "deque" = deque(maxlen=window + 1)

    def step(self, n: int = 1):
        """Record ``n`` completed steps."""
        self._steps += n
        if self._steps <= self.warmup_steps:
            return
        now = time.perf_counter()
        if self._times and now - self._times[-1][0] < 0.005:
            t, c = self._times[-1]
            self._times[-1] = (t, c + n)
        else:
            self._times.append((now, n))

    def _window(self):
        n = sum(c for _, c in list(self._times)[1:])
        return n, self._times[-1][0] - self._times[0][0]

    @property
    def tokens_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        n, dt = self._window()
        return n * self.tokens_per_step / dt if dt > 0 else 0.0

    @property
    def step_ms(self) -> float:
        if len(self._times) < 2:
            return 0.0
        n, dt = self._window()
        return dt / max(n, 1) * 1000.0
