"""Per-run metric streams: ``params.json``, ``metrics.jsonl`` and
``artifacts.json`` under one run directory.

Port of protgram_directgcn_tpu/utils/metrics.py (reference: main.py:40-96,
ppi_main.py:299-311), json only.  Where the ``mlflow`` package imports and
mirroring is asked for (``PROTGRAM_MLFLOW=1``, or ``MetricLogger(...,
mlflow=True)``), every call is mirrored into an MLflow run named after the
run; without the package the JSON files are written all the same.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from protgram_directgcn_torch.utils.io import ensure_dir, logger


def _mlflow_module():
    try:
        import mlflow  # noqa: F401 (optional)

        return mlflow
    except Exception:
        return None


class MetricLogger:
    """One run = one directory: params.json, metrics.jsonl, artifacts.json."""

    def __init__(self, run_dir: os.PathLike, run_name: str = "run",
                 mlflow: Optional[bool] = None):
        self.run_dir = ensure_dir(run_dir)
        self.run_name = run_name
        self._metrics_file = open(os.path.join(str(self.run_dir), "metrics.jsonl"), "a")
        self._artifacts: Dict[str, str] = {}
        self._t0 = time.time()
        self._step_counter = 0
        want_mlflow = os.environ.get("PROTGRAM_MLFLOW") == "1" if mlflow is None else mlflow
        self._mlflow = _mlflow_module() if want_mlflow else None
        self._mlflow_run = None
        if want_mlflow and self._mlflow is None:
            logger.info("PROTGRAM_MLFLOW requested but the mlflow package is not importable; "
                        "metrics stay JSONL-only")
        if self._mlflow is not None:
            try:
                # nested=True composes with an active parent run (main.py:40-96).
                self._mlflow_run = self._mlflow.start_run(
                    run_name=run_name, nested=bool(self._mlflow.active_run()))
            except Exception as exc:  # tracking never stops the pipeline
                logger.warning("mlflow.start_run failed (%s); JSONL-only", exc)
                self._mlflow = None

    def log_params(self, params: Dict[str, Any]) -> None:
        with open(os.path.join(str(self.run_dir), "params.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)
        if self._mlflow is not None:
            try:
                self._mlflow.log_params({k: str(v) for k, v in params.items()})
            except Exception as exc:
                logger.warning("mlflow.log_params failed: %s", exc)

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"t": round(time.time() - self._t0, 3), "run": self.run_name}
        if step is not None:
            record["step"] = step
        record.update({k: (float(v) if hasattr(v, "__float__") else v)
                       for k, v in metrics.items()})
        self._metrics_file.write(json.dumps(record) + "\n")
        self._metrics_file.flush()
        if self._mlflow is not None:
            numeric = {k: float(v) for k, v in metrics.items() if hasattr(v, "__float__")}
            if numeric:
                try:
                    self._mlflow.log_metrics(
                        numeric, step=self._step_counter if step is None else step)
                except Exception as exc:
                    logger.warning("mlflow.log_metrics failed: %s", exc)
            self._step_counter += 1

    def log_artifact(self, name: str, path: os.PathLike) -> None:
        self._artifacts[name] = str(path)
        with open(os.path.join(str(self.run_dir), "artifacts.json"), "w") as f:
            json.dump(self._artifacts, f, indent=2)
        if self._mlflow is not None and os.path.exists(str(path)):
            try:
                self._mlflow.log_artifact(str(path))
            except Exception as exc:
                logger.warning("mlflow.log_artifact failed: %s", exc)

    def close(self) -> None:
        self._metrics_file.close()
        if self._mlflow is not None and self._mlflow_run is not None:
            try:
                self._mlflow.end_run()
            except Exception:
                pass

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(run_dir: os.PathLike) -> List[dict]:
    """A run's metric stream as a list of dicts."""
    path = os.path.join(str(run_dir), "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
