"""Configuration dataclasses for the MEPS numpy-file datastore.

Schema matches the reference
(reference: neural_lam/datastore/npyfilesmeps/config.py:12-74) so
existing ``data_config.yaml`` files parse unchanged; the loader is
hand-rolled YAML instead of dataclass_wizard.

The port's own copy of ``neural_lam_tpu/datastore/npyfilesmeps/config.py``;
PyYAML is imported where the file is read.
"""

from __future__ import annotations

import dataclasses
import re
from datetime import timedelta
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class Projection:
    """Cartopy projection spec: class name + constructor kwargs."""

    class_name: str
    kwargs: dict[str, Any]


@dataclasses.dataclass
class Dataset:
    """Dataset metadata: variables, timesteps, ensemble size."""

    name: str
    var_names: list[str]
    var_units: list[str]
    var_longnames: list[str]
    num_forcing_features: int
    num_timesteps: int
    step_length: timedelta
    num_ensemble_members: int
    remove_state_features_with_index: list[int] = dataclasses.field(
        default_factory=list
    )


@dataclasses.dataclass
class NpyDatastoreConfig:
    """Top-level MEPS datastore configuration."""

    dataset: Dataset
    grid_shape_state: list[int]  # [ny, nx], matching the reference layout
    projection: Projection

    @classmethod
    def from_yaml_file(cls, path: str | Path) -> "NpyDatastoreConfig":
        import yaml  # where the file is read, as in datastore/mdp.py

        with open(path, "r", encoding="utf-8") as f:
            data = yaml.safe_load(f)
        ds = dict(data["dataset"])
        step_length = ds["step_length"]
        if not isinstance(step_length, timedelta):
            # Plain numbers mean hours (the reference YAML convention);
            # ISO-8601 duration strings ("PT3H", "PT30M", "P1DT6H", ...)
            # are also accepted and must parse fully — a silent
            # timedelta(0) would corrupt every time coordinate downstream.
            if isinstance(step_length, str):
                m = re.fullmatch(
                    r"P(?:(\d+(?:\.\d+)?)D)?"
                    r"(?:T(?:(\d+(?:\.\d+)?)H)?"
                    r"(?:(\d+(?:\.\d+)?)M)?"
                    r"(?:(\d+(?:\.\d+)?)S)?)?",
                    step_length.strip().upper(),
                )
                if m is None or not any(m.groups()):
                    raise ValueError(
                        f"Cannot parse step_length {step_length!r} as an "
                        "ISO-8601 duration (expected e.g. 'PT3H', 'PT30M')"
                    )
                d, h, mi, sec = (
                    float(g) if g else 0.0 for g in m.groups()
                )
                step_length = timedelta(
                    days=d, hours=h, minutes=mi, seconds=sec
                )
            else:
                step_length = timedelta(hours=float(step_length))
        ds["step_length"] = step_length
        return cls(
            dataset=Dataset(**ds),
            grid_shape_state=list(data["grid_shape_state"]),
            projection=Projection(**data["projection"]),
        )
