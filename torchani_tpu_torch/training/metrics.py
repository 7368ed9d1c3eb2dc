"""Scalar training-metrics channel (counterpart of
``torchani_tpu/training/metrics.py``, in its file format): an append-only
JSONL file, one object per record (step, wall time since the writer opened,
named scalars), with an optional CSV mirror for spreadsheets.
`read_metrics` loads a run back as columns; either package reads the
other's files.
"""

import csv
import json
import time
import typing as tp
from pathlib import Path

__all__ = ["MetricsWriter", "read_metrics"]


def _scalar(v: tp.Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        raise TypeError(f"metric value {v!r} is not scalar-coercible")


class MetricsWriter:
    """Append-only JSONL scalar writer (optionally mirrored to CSV).

    >>> with MetricsWriter(dir / "metrics.jsonl") as w:
    ...     w.write(epoch, {"loss": loss, "lr": lr, "val_rmse": rmse})

    Records are flushed per write, so a killed run keeps everything
    recorded so far.  A scalar may be a 0-d tensor on any device (read
    once, here).  The CSV mirror derives its header from the first
    record; later records may add keys, which go to the JSONL only.
    """

    def __init__(self, path, csv_mirror: bool = False) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)
        self._csv: tp.Optional[tp.Any] = None
        self._csv_fields: tp.Optional[tp.List[str]] = None
        self._csv_path = self.path.with_suffix(".csv") if csv_mirror else None
        self._t0 = time.time()

    def write(self, step: int, metrics: tp.Mapping[str, tp.Any]) -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        rec.update({k: _scalar(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        if self._csv_path is not None:
            if self._csv is None:
                self._csv_fields = list(rec)
                new = not self._csv_path.exists()
                self._csv = open(self._csv_path, "a", buffering=1, newline="")
                self._writer = csv.DictWriter(
                    self._csv, fieldnames=self._csv_fields, extrasaction="ignore"
                )
                if new:
                    self._writer.writeheader()
            self._writer.writerow(rec)

    def close(self) -> None:
        self._fh.close()
        if self._csv is not None:
            self._csv.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_metrics(path) -> tp.Dict[str, tp.List[float]]:
    """Load a JSONL metrics file as column lists (missing keys -> nan)."""
    records = [
        json.loads(line)
        for line in Path(path).read_text().splitlines()
        if line.strip()
    ]
    keys: tp.List[str] = []
    for r in records:
        for k in r:
            if k not in keys:
                keys.append(k)
    return {
        k: [float(r.get(k, float("nan"))) for r in records] for k in keys
    }
