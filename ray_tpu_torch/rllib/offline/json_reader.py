"""JsonReader: sample batches from JSON-lines experience files.

The counterpart of ``ray_tpu/rllib/offline/json_reader.py``, and its file
format byte for byte, so each package reads the other's files; reference:
`rllib/offline/json_reader.py` — reads the files produced by `JsonWriter` (one
episode/fragment batch per line), shuffles at the line level, and serves
fixed-size transition batches. Episode boundaries are preserved in `dones` so
return computation never leaks across lines: a synthetic done closes each
line's tail even for fragments.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Sequence, Union

import numpy as np

from ray_tpu_torch.rllib.offline.input_reader import InputReader


def _expand(paths: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "*.json"))))
        else:
            files.extend(sorted(glob.glob(p)) or [p])
    if not files:
        raise FileNotFoundError(f"no offline data files match {paths!r}")
    return files


class JsonReader(InputReader):
    """Streams one file at a time (files are bounded by the writer's
    `max_file_size`), shuffling file order per epoch and episode order within
    each file — the whole dataset is never resident (reference: the streaming
    `json_reader.py` shuffles at file granularity the same way)."""

    def __init__(self, inputs: Union[str, Sequence[str]],
                 batch_size: int = 256, seed: int = 0):
        self.files = _expand(inputs)
        missing = [f for f in self.files if not os.path.exists(f)]
        if missing:
            raise FileNotFoundError(f"offline data files not found: {missing}")
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self._file_order: List[int] = []
        self._loaded: List[Dict[str, np.ndarray]] = []
        self._cursor = 0

    @staticmethod
    def _parse_line(line: str) -> Dict[str, np.ndarray]:
        row = json.loads(line)
        ep = {k: np.asarray(v) for k, v in row.items()}
        n = len(ep["actions"])
        # Close the line's tail so per-batch return computation treats
        # every line as a self-contained segment.
        dones = np.zeros(n, np.float32)
        for key in ("dones", "terminateds", "truncateds"):
            if key in ep:
                dones = np.maximum(dones, np.asarray(ep[key], np.float32))
        dones[-1] = 1.0
        ep["dones"] = dones
        return ep

    def _load_next_file(self) -> None:
        """Parse one file's episodes into the serving window."""
        attempts = 0
        while not self._loaded:
            if not self._file_order:
                if attempts >= len(self.files):
                    raise ValueError(
                        f"offline files {self.files} contain no batches"
                    )
                self._file_order = list(
                    self._rng.permutation(len(self.files))
                )
            fname = self.files[self._file_order.pop()]
            attempts += 1
            with open(fname) as fh:
                episodes = [
                    self._parse_line(line)
                    for line in fh
                    if line.strip()
                ]
            self._rng.shuffle(episodes)
            self._loaded = episodes
            self._cursor = 0

    def _next_episode(self) -> Dict[str, np.ndarray]:
        if self._cursor >= len(self._loaded):
            self._loaded = []
            self._load_next_file()
        ep = self._loaded[self._cursor]
        self._cursor += 1
        return ep

    def next(self) -> Dict[str, np.ndarray]:
        """Concatenate whole episodes until `batch_size` transitions."""
        chunks: List[Dict[str, np.ndarray]] = []
        rows = 0
        while rows < self.batch_size:
            ep = self._next_episode()
            chunks.append(ep)
            rows += len(ep["actions"])
        keys = set(chunks[0])
        for c in chunks[1:]:
            keys &= set(c)
        return {
            k: np.concatenate([np.asarray(c[k]) for c in chunks]) for k in keys
        }
