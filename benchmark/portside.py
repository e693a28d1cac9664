"""What the benchmark takes from the program (``neural_lam_tpu_torch``):
the system under test, built through its normal entry points. The seeded
inputs reach it through its own datastore interface and graph loader;
nothing here computes a result the check compares.

The program is imported inside these functions, so that the plain
reference and the tests of it load nothing of it.
"""

from __future__ import annotations

from datetime import timedelta
from pathlib import Path

import numpy as np


def seeded_store(cfg: dict, stats: dict, root: Path, xy: np.ndarray, mask: np.ndarray):
    """A regular-grid datastore of the port that serves the seeded
    statistics, static fields and boundary mask; its ``root_path`` holds
    the graph. It has no time series: batches come from the pools."""
    from neural_lam_tpu_torch.datastore.base import BaseRegularGridDatastore, CartesianGridShape
    from neural_lam_tpu_torch.utils.labeled import FieldArray

    counts = {"state": cfg["state_vars"], "forcing": cfg["forcing_vars"],
              "static": cfg["static_vars"]}

    class SeededStore(BaseRegularGridDatastore):
        is_forecast = False
        is_ensemble = False
        has_ensemble_forcing = False

        root_path = Path(root)
        config: dict = {}
        step_length = timedelta(hours=3)
        grid_shape_state = CartesianGridShape(x=cfg["grid_x"], y=cfg["grid_y"])

        def get_vars_names(self, category):
            return [f"{category}_{i}" for i in range(counts[category])]

        def get_vars_units(self, category):
            return ["1"] * counts[category]

        def get_vars_long_names(self, category):
            return self.get_vars_names(category)

        def get_num_data_vars(self, category):
            return counts[category]

        def get_standardization_dataarray(self, category):
            out = {f"{category}_mean": stats[f"{category}_mean"],
                   f"{category}_std": stats[f"{category}_std"]}
            if category == "state":
                out["state_diff_mean_standardized"] = stats["diff_mean"]
                out["state_diff_std_standardized"] = stats["diff_std"]
            return out

        def get_dataarray(self, category, split, standardize=False):
            if category != "static":
                raise ValueError("the benchmark's store holds no time series")
            da = FieldArray(
                data=stats["static"], dims=("grid_index", "static_feature"),
                coords={"grid_index": np.arange(stats["static"].shape[0]),
                        "static_feature": np.array(self.get_vars_names("static"))})
            return self._standardize_dataarray(da, "static") if standardize else da

        @property
        def boundary_mask(self):
            return FieldArray(data=mask, dims=("grid_index",),
                              coords={"grid_index": np.arange(mask.shape[0])})

        def get_xy(self, category, stacked):
            return xy.reshape(-1, 2) if stacked else xy

    return SeededStore()


def build_model(family, cfg: dict, store, weights: dict, device, precision: str):
    """The family's port model on ``store`` at the configuration's widths,
    its parameters copied from ``weights``, and its forecaster."""
    import torch

    from neural_lam_tpu_torch import models

    cls = getattr(models, family.PORT_CLASS)
    model = cls(
        store, graph_name=cfg["graph"], hidden_dim=cfg["hidden_dim"],
        hidden_layers=cfg["hidden_layers"], processor_layers=cfg["processor_layers"],
        mesh_aggr=cfg["mesh_aggr"], num_past_forcing_steps=cfg["forcing_window"] // 2,
        num_future_forcing_steps=cfg["forcing_window"] // 2, device=device,
        compute_dtype=torch.bfloat16 if precision == "bf16" else torch.float32,
    )
    model.load_state_dict(weights, strict=True)
    return model, models.ARForecaster(model, store)


def trainer(forecaster, store, mix: dict, device):
    """The port's ``Trainer`` with the mix's hyperparameters."""
    from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
    from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

    config = NeuralLAMConfig(datastore=DatastoreSelection(kind="benchmark", config_path=""))
    args = TrainingArgs(batch_size=mix["batch"], ar_steps_train=mix["ar_steps"], lr=mix["lr"],
                        weight_decay=mix["weight_decay"], precision=mix["precision"])
    return Trainer(forecaster, config, store, args, device=device)


def forecast(forecaster, store, cfg: dict, device):
    """The port's captured forecast, ``predict.make_forecast``."""
    from neural_lam_tpu_torch.predict import make_forecast

    half = cfg["forcing_window"] // 2
    return make_forecast(forecaster, store, device=device, num_past_forcing_steps=half,
                         num_future_forcing_steps=half)


def build_kernels(names: list[str]) -> None:
    """Build the named kernel libraries of the port (``csrc/<name>.cu``)
    that are not built yet, all at once (``ops/kernel_build.py``, into
    ``build/kernels/`` of the checkout). A library left out is built when
    it is first loaded."""
    from neural_lam_tpu_torch.ops import kernel_build

    kernel_build.build(names)
