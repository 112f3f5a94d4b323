"""History H of experimental measurements (EaCO Alg. 1, line 1).

Maps a co-location signature (sorted job-family names) to the measured
epoch-time inflation factor.  Seeded with the paper's own experiments
(Tables 1-4) and grown online from early-stage observations; persists to
JSON so accumulated measurements survive across scheduler runs — "a larger
data history allows it to make faster and more accurate estimates" (§5).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.cluster import colocation
from repro_torch.cluster.power import PAPER_COLOCATED

Signature = Tuple[str, ...]


class History:
    """The measurement history H: co-location signature -> measured
    epoch-time inflation, seeded from the paper's Table 3 sets and grown
    online by EaCO's observation phase (plus bridge calibrations)."""

    def __init__(self, seed_with_paper: bool = True):
        self._data: Dict[Signature, float] = {}
        self.hits = 0
        self.misses = 0
        if seed_with_paper:
            for sig in PAPER_COLOCATED:
                measured = colocation.paper_measured_inflation(sig)
                if measured is not None:
                    self._data[tuple(sorted(sig))] = measured

    def get(self, signature: Iterable[str], count: bool = True) -> Optional[float]:
        """Measured inflation for ``signature`` (None = miss; 1.0 for
        singleton sets); updates the hit/miss counters unless
        ``count=False`` (telemetry reads must not distort the stats)."""
        key = tuple(sorted(signature))
        if len(key) <= 1:
            return 1.0
        val = self._data.get(key)
        if count:
            if val is None:
                self.misses += 1
            else:
                self.hits += 1
        return val

    def record(self, signature: Iterable[str], inflation: float) -> None:
        """Store an observed inflation (overwrites: measurements win)."""
        key = tuple(sorted(signature))
        if len(key) > 1:
            self._data[key] = inflation

    def seed_from(self, measurements: Dict[Signature, float]) -> int:
        """Bulk-seed measured signatures (the bridge's "experiment-based"
        H growth: §5 — a larger data history gives faster, more accurate
        estimates).  Existing entries win: a paper-measured or online-
        observed value is never overwritten by an offline calibration.
        Returns the number of newly-seeded signatures."""
        added = 0
        for sig, infl in measurements.items():
            key = tuple(sorted(sig))
            if len(key) > 1 and key not in self._data:
                self._data[key] = float(infl)
                added += 1
        return added

    @classmethod
    def from_calibration(cls, calibration, seed_with_paper: bool = True) -> "History":
        """History seeded from the paper tables plus a ``repro_torch.bridge``
        ``Calibration`` (anything with a ``signatures`` mapping)."""
        h = cls(seed_with_paper=seed_with_paper)
        h.seed_from(calibration.signatures)
        return h

    def signatures(self) -> Dict[Signature, float]:
        """Copy of the signature -> inflation table."""
        return dict(self._data)

    def __len__(self) -> int:
        return len(self._data)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist the table as JSON (signatures joined with ``|``)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"|".join(k): v for k, v in self._data.items()}, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "History":
        """Paper-seeded History plus the entries stored at ``path`` (which
        may be absent: persistence is best-effort)."""
        h = cls(seed_with_paper=True)
        if os.path.exists(path):
            with open(path) as f:
                for k, v in json.load(f).items():
                    h._data[tuple(k.split("|"))] = float(v)
        return h
