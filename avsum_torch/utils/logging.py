"""``JsonlLogger`` (``avsum_tpu/utils/logging.py``), which the port cannot
import: ``avsum_tpu.utils``'s package ``__init__`` imports jax."""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional


class JsonlLogger:
    """Append-only JSONL scalar sink (one dict per line, wall-clock stamped)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def log(self, step: int, **scalars: Any) -> Dict[str, Any]:
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        return record

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
