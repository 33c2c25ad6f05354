"""JsonWriter: persist experience batches as JSON-lines files.

The counterpart of ``ray_tpu/rllib/offline/json_writer.py``, and its file
format byte for byte, so each package reads the other's files; reference:
`rllib/offline/json_writer.py` — each `write()` emits one line holding the
batch's columns. Write episode-complete batches so readers can compute exact
Monte-Carlo returns (MARWIL); the trailing row of a complete episode has
terminateds/truncateds true.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np


class JsonWriter:
    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        self.max_file_size = max_file_size
        self._file_index = 0
        self._fh: Optional[Any] = None
        os.makedirs(path, exist_ok=True)

    def _file(self):
        if self._fh is None or self._fh.tell() > self.max_file_size:
            if self._fh is not None:
                self._fh.close()
                self._file_index += 1
            name = os.path.join(self.path, f"output-{self._file_index:05d}.json")
            self._fh = open(name, "a")
        return self._fh

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        row = {k: np.asarray(v).tolist() for k, v in batch.items()}
        fh = self._file()
        fh.write(json.dumps(row) + "\n")
        fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
