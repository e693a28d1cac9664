"""Forecast export: roll a forecaster out over a split and write the fields.

Counterpart of the body of ``neural_lam_tpu/predict.py``. For each sample
of the split, :func:`run_forecasts` writes ``forecast_<split>_<i>.npz``
with

- ``prediction``: ``(ar_steps, num_grid_points, d_state)`` float32 in
  PHYSICAL units (destandardized),
- ``pred_std``: same shape, physical units (models with an output-std
  head only),
- ``target_times``: ``(ar_steps,)`` int64 epoch-nanoseconds,

plus one ``forecast_meta.json``. Boundary forcing uses the split's own
analysis states (reference: models/forecasters/autoregressive.py:116-136).
The command line, which loads a trained checkpoint, comes with the
checkpoint slice.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .dataset import WeatherDataset
from .datastore.base import BaseDatastore
from .loader import DataLoader
from .models.forecaster import ARForecaster
from .trainer import standardization_stats, standardize_batch
from .utils.device import resolve_device


def run_forecasts(
    forecaster: ARForecaster,
    datastore: BaseDatastore,
    split: str = "test",
    ar_steps: int = 19,
    batch_size: int = 4,
    n_samples: int = -1,
    out_dir: str | Path = "forecasts",
    device: str | torch.device = "cuda",
    num_past_forcing_steps: int = 1,
    num_future_forcing_steps: int = 1,
) -> int:
    """Forecast ``n_samples`` samples of ``split`` (all with -1) in
    batches of ``batch_size`` and write them to ``out_dir``; returns the
    number of forecasts written.

    Inputs are standardized and outputs destandardized with the same
    (eps-clamped) stats, so the pair is an exact inverse even for
    zero-std variables. The tail batch runs at its own size.
    """
    dev = resolve_device(device)
    dataset = WeatherDataset(
        datastore,
        split=split,
        ar_steps=ar_steps,
        num_past_forcing_steps=num_past_forcing_steps,
        num_future_forcing_steps=num_future_forcing_steps,
    )
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False)
    stats = standardization_stats(datastore)
    state_mean, state_std = stats["state_mean"], stats["state_std"]

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = {
        "split": split,
        "ar_steps": ar_steps,
        "model": type(forecaster.predictor).__name__,
        "var_names": list(datastore.get_vars_names("state")),
        "var_units": list(datastore.get_vars_units("state")),
        "num_grid_points": int(datastore.num_grid_points),
        "grid_shape": [
            int(datastore.grid_shape_state.x),
            int(datastore.grid_shape_state.y),
        ],
        "step_length_hours": int(
            np.asarray(datastore.step_length, dtype="timedelta64[h]").astype(
                np.int64
            )
        ),
        "units": "physical (destandardized)",
    }
    (out_dir / "forecast_meta.json").write_text(
        json.dumps(meta, indent=2), encoding="utf-8"
    )

    limit = n_samples if n_samples >= 0 else len(dataset)
    written = 0
    for init, target, forcing, times in loader:
        if written >= limit:
            break
        init, target, forcing = (
            torch.from_numpy(a).to(dev) for a in (init, target, forcing)
        )
        with torch.inference_mode():
            init_s, target_s, forcing_s = standardize_batch(
                init, target, forcing, stats
            )
            prediction, pred_std = forecaster(init_s, forcing_s, target_s)
        prediction = prediction.cpu().numpy()
        pred_std = None if pred_std is None else pred_std.cpu().numpy()
        for i in range(prediction.shape[0]):
            if written >= limit:
                break
            arrays = {
                "prediction": (prediction[i] * state_std + state_mean).astype(
                    np.float32
                ),
                "target_times": times[i],
            }
            if pred_std is not None:
                arrays["pred_std"] = (pred_std[i] * state_std).astype(np.float32)
            np.savez_compressed(
                out_dir / f"forecast_{split}_{written:05d}.npz", **arrays
            )
            written += 1
    return written
