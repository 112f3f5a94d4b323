"""Flat columnar storage shared by the telemetry hub and the audit log."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np


class ColumnTable:
    """Append-only columnar store: one flat Python list per column.

    NumPy-friendly: ``to_numpy()`` converts each column in one
    ``np.asarray`` call; ``rows()`` iterates dict-rows for JSONL export.
    Appends are plain list appends — no per-row object allocation — which
    is what keeps a 10k-job replay with telemetry enabled within a few
    percent of the telemetry-off baseline.
    """

    def __init__(self, columns: Sequence[str]):
        self.columns: Tuple[str, ...] = tuple(columns)
        self._cols: Tuple[list, ...] = tuple([] for _ in self.columns)

    def append(self, *values: Any) -> None:
        """Append one row (positional, one value per column)."""
        for col, v in zip(self._cols, values):
            col.append(v)

    def column(self, name: str) -> list:
        """The raw (mutable) list backing column ``name``."""
        return self._cols[self.columns.index(name)]

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Columns as NumPy arrays (object dtype for string columns)."""
        return {n: np.asarray(c) for n, c in zip(self.columns, self._cols)}

    def rows(self) -> Iterator[Dict[str, Any]]:
        """Iterate rows as dicts (for JSONL export / tests)."""
        for tup in zip(*self._cols):
            yield dict(zip(self.columns, tup))

    def __len__(self) -> int:
        return len(self._cols[0]) if self._cols else 0
