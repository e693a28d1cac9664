"""Forecast export CLI: load a trained checkpoint, write forecasts.

Counterpart of ``neural_lam_tpu/predict.py``::

    python -m neural_lam_tpu_torch.predict --config_path cfg.yaml \
        --load runs/myrun --split test --ar_steps 19 --out forecasts/

:func:`main` loads the forecaster from the checkpoint
(``checkpoint.load_forecaster_from_checkpoint``, with the ``--load``
forms of the training CLI) on ``cuda``, or on the device it is given,
and calls :func:`run_forecasts`, which rolls it out over the split. For
each sample it writes ``forecast_<split>_<i>.npz`` with

- ``prediction``: ``(ar_steps, num_grid_points, d_state)`` float32 in
  PHYSICAL units (destandardized),
- ``pred_std``: same shape, physical units (models with an output-std
  head only),
- ``target_times``: ``(ar_steps,)`` int64 epoch-nanoseconds,

plus one ``forecast_meta.json``. Boundary forcing uses the split's own
analysis states (reference: models/forecasters/autoregressive.py:116-136).

On CUDA the forecast (standardize, then ``ARForecaster.forward``) is a
CUDA graph per request shape (``utils.cuda_graph.CapturedFunction``), the
counterpart of the JAX CLI's jitted ``forecast``; on the CPU it runs
eagerly. A short tail batch is padded to ``batch_size`` by repeating its
last sample, as the JAX CLI pads it, so that it replays the full batch's
graph; the padded rows are dropped. The JAX CLI's floor of batch 2, a
TPU lane workaround, is not carried over.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .dataset import WeatherDataset
from .datastore.base import BaseDatastore
from .loader import DataLoader
from .models.forecaster import ARForecaster
from .trainer import device_stats, standardization_stats, standardize_batch
from .utils.cuda_graph import CapturedFunction
from .utils.device import resolve_device


def make_forecast(
    forecaster: ARForecaster,
    datastore: BaseDatastore,
    device: str | torch.device = "cuda",
    num_past_forcing_steps: int = 1,
    num_future_forcing_steps: int = 1,
) -> CapturedFunction:
    """The forecast ``(init, target, forcing) -> (prediction, pred_std)``
    in standardized units, from physical inputs on ``device``: the
    counterpart of the JAX CLI's jitted ``forecast``. A CUDA graph per
    request shape and route on the card, eager on the CPU."""
    dev = resolve_device(device)
    # the stats on the device once, not four copies per batch (nor inside
    # a capture, where a copy from the host is not allowed)
    window = num_past_forcing_steps + num_future_forcing_steps + 1
    stats = device_stats(
        standardization_stats(datastore),
        window * datastore.get_num_data_vars("forcing"),
        dev,
    )

    def forecast(init, target, forcing):
        init_s, target_s, forcing_s = standardize_batch(init, target, forcing, stats)
        return forecaster(init_s, forcing_s, target_s)

    return CapturedFunction(forecast, forecaster, dev)


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
    model_name: Optional[str] = None,
) -> int:
    """Forecast ``n_samples`` samples of ``split`` (all with -1) in
    batches of ``batch_size`` and write them to ``out_dir``; returns the
    number of forecasts written. ``model_name`` is the ``model`` entry of
    ``forecast_meta.json`` (the CLI's ``--model`` name from the
    checkpoint); by default the predictor's class name.

    Inputs are standardized and outputs destandardized with the same
    (eps-clamped) stats, so the pair is an exact inverse even for
    zero-std variables. The tail batch is padded to ``batch_size`` by
    repeating its last sample and its padded rows dropped.
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
    forecast = make_forecast(
        forecaster, datastore, dev, num_past_forcing_steps, num_future_forcing_steps
    )

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = {
        "split": split,
        "ar_steps": ar_steps,
        "model": model_name or type(forecaster.predictor).__name__,
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
        real = init.shape[0]
        pad = batch_size - real
        if pad > 0:
            init, target, forcing = (
                np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                for a in (init, target, forcing)
            )
        prediction, pred_std = forecast(
            *(torch.from_numpy(a).to(dev) for a in (init, target, forcing))
        )
        prediction = prediction[:real].cpu().numpy()
        pred_std = None if pred_std is None else pred_std[:real].cpu().numpy()
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument(
        "--load",
        type=str,
        required=True,
        help="Run dir, its checkpoints/ dir, or a specific checkpoint "
        "(.../checkpoints/{latest,min_val_loss})",
    )
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument(
        "--ar_steps", type=int, default=19,
        help="Rollout length (the 19-step MEPS protocol by default)",
    )
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument(
        "--n_samples", type=int, default=-1,
        help="Number of samples to export (-1 = the whole split)",
    )
    parser.add_argument("--out", type=str, required=True)
    return parser


def main(argv=None, device: str | torch.device = "cuda") -> None:
    """Export forecasts from a checkpoint, on ``device``."""
    from .checkpoint import load_forecaster_from_checkpoint, resolve_load
    from .config import load_config_and_datastore

    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    _, datastore = load_config_and_datastore(args.config_path)
    root, name = resolve_load(args.load)
    forecaster, hparams = load_forecaster_from_checkpoint(
        root, datastore, name=name, device=dev
    )
    print(f"loaded checkpoint {name!r} from {root}", file=sys.stderr)
    written = run_forecasts(
        forecaster,
        datastore,
        split=args.split,
        ar_steps=args.ar_steps,
        batch_size=args.batch_size,
        n_samples=args.n_samples,
        out_dir=args.out,
        device=dev,
        num_past_forcing_steps=hparams.get("num_past_forcing_steps", 1),
        num_future_forcing_steps=hparams.get("num_future_forcing_steps", 1),
        model_name=hparams.get("model"),
    )
    print(f"wrote {written} forecasts to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
