"""Training loggers: CSV/JSONL native, W&B / MLflow adapters when present.

Counterpart of the reference logger stack (W&B via Lightning, MLflow via
``CustomMLFlowLogger``; reference: neural_lam/custom_loggers.py:15-123,
neural_lam/utils.py:717-797). The native CSV/JSONL logger has no
dependencies and is the default; the W&B and MLflow adapters activate
only if their packages are importable, and all three share one small
interface: ``log_metrics``, ``log_image``, ``finish``.

The port's own copy of ``neural_lam_tpu/loggers.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional


class BaseLogger:
    """Minimal metric/image logging interface."""

    def log_metrics(self, metrics: dict, step: Optional[int] = None) -> None:
        raise NotImplementedError

    def log_image(self, key: str, figure, step: Optional[int] = None) -> None:
        raise NotImplementedError

    def log_hparams(self, hparams: dict) -> None:
        pass

    def watch_min_metrics(self, keys: "list[str]") -> None:
        """Mark metrics whose run-level summary should be the minimum
        (reference: neural_lam/utils.py:689-713). No-op for backends
        without summary aggregation."""

    def finish(self) -> None:
        pass


class NullLogger(BaseLogger):
    def log_metrics(self, metrics, step=None):
        pass

    def log_image(self, key, figure, step=None):
        pass


class CSVLogger(BaseLogger):
    """JSONL metrics + PNG figures under ``run_dir``."""

    def __init__(self, run_dir: str | Path) -> None:
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._metrics_path = self.run_dir / "metrics.jsonl"
        self._figures_dir = self.run_dir / "figures"

    def log_metrics(self, metrics, step=None):
        record = dict(metrics)
        if step is not None:
            record["step"] = step
        with open(self._metrics_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def log_image(self, key, figure, step=None):
        self._figures_dir.mkdir(parents=True, exist_ok=True)
        safe_key = key.replace("/", "_")
        suffix = f"_{step}" if step is not None else ""
        figure.savefig(
            self._figures_dir / f"{safe_key}{suffix}.png",
            bbox_inches="tight",
            dpi=150,
        )

    def log_hparams(self, hparams):
        (self.run_dir / "hparams.json").write_text(
            json.dumps(hparams, indent=2, default=str), encoding="utf-8"
        )


class WandbLogger(BaseLogger):
    """W&B adapter; supports resume-by-id like the reference
    (reference: neural_lam/utils.py:746-772)."""

    def __init__(
        self,
        project: str,
        run_name: Optional[str] = None,
        run_id: Optional[str] = None,
        config: Optional[dict] = None,
    ) -> None:
        import wandb  # gated import

        self._wandb = wandb
        self.run = wandb.init(
            project=project,
            name=run_name,
            id=run_id,
            resume="allow" if run_id else None,
            config=config,
        )

    def log_metrics(self, metrics, step=None):
        self._wandb.log(dict(metrics), step=step)

    def log_image(self, key, figure, step=None):
        # W&B drops any log whose explicit step is below the run's
        # current step ("Step must only increase" -> silently
        # discarded). Our image ``step`` values are LEAD TIMES, not
        # timeline steps (e.g. spatial-loss step 1 logged after example
        # images at step 19, or any eval resumed onto a training run's
        # id), so fold the lead into the key and let W&B auto-advance.
        if step is not None:
            key = f"{key}_step{step}"
        self._wandb.log({key: self._wandb.Image(figure)})

    def log_hparams(self, hparams):
        self.run.config.update(hparams, allow_val_change=True)

    def watch_min_metrics(self, keys):
        for key in keys:
            self.run.define_metric(key, summary="min")

    def finish(self):
        self._wandb.finish()


class MLFlowLogger(BaseLogger):
    """MLflow adapter with ``log_image`` support, matching the reference's
    ``CustomMLFlowLogger`` additions
    (reference: neural_lam/custom_loggers.py:73-123)."""

    def __init__(
        self,
        experiment: str,
        run_name: Optional[str] = None,
        tracking_uri: Optional[str] = None,
    ) -> None:
        import mlflow  # gated import

        self._mlflow = mlflow
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(experiment)
        self.run = mlflow.start_run(run_name=run_name)

    def log_metrics(self, metrics, step=None):
        self._mlflow.log_metrics(
            {k: float(v) for k, v in metrics.items()}, step=step
        )

    def log_image(self, key, figure, step=None):
        safe_key = key.replace("/", "_")
        suffix = f"_{step}" if step is not None else ""
        self._mlflow.log_figure(figure, f"{safe_key}{suffix}.png")

    def log_hparams(self, hparams):
        self._mlflow.log_params(
            {k: str(v) for k, v in hparams.items()}
        )

    def finish(self):
        self._mlflow.end_run()


def setup_training_logger(
    logger: str,
    run_dir: str | Path,
    project: str = "neural_lam",
    run_name: Optional[str] = None,
    run_id: Optional[str] = None,
    config: Optional[dict] = None,
) -> BaseLogger:
    """Select and construct a logger (reference: neural_lam/utils.py:717).

    Unavailable backends fall back to CSV with a console note rather
    than failing the run.
    """
    if logger == "none":
        return NullLogger()
    if logger == "wandb":
        # Exception, not just ImportError: wandb.init raises its own
        # UsageError/CommError when not logged in / offline — the
        # documented contract is "fall back to CSV, don't fail the run"
        try:
            return WandbLogger(
                project=project,
                run_name=run_name,
                run_id=run_id,
                config=config,
            )
        except Exception as e:  # noqa: BLE001 — fallback by contract
            print(
                f"wandb unavailable ({type(e).__name__}: {e}); "
                "falling back to CSV logger"
            )
    elif logger == "mlflow":
        try:
            return MLFlowLogger(experiment=project, run_name=run_name)
        except Exception as e:  # noqa: BLE001 — fallback by contract
            print(
                f"mlflow unavailable ({type(e).__name__}: {e}); "
                "falling back to CSV logger"
            )
    elif logger != "csv":
        raise ValueError(
            f"Unknown logger {logger!r} "
            "(available: csv, wandb, mlflow, none)"
        )
    return CSVLogger(run_dir)
