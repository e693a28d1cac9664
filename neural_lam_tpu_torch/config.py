"""Configuration system: YAML -> dataclasses with tagged unions.

Counterpart of ``neural_lam_tpu/config.py``, the port's own copy. Mirrors
the reference config schema (reference: neural_lam/config.py:20-207)
— datastore selection, per-feature loss weighting, output clamping — with
a small hand-rolled loader instead of dataclass_wizard. Polymorphic
fields select their class via a ``__config_class__`` tag, exactly like
the reference YAML format, so existing config files parse unchanged.
PyYAML is imported where a file is read, not with the module, so the
dataclasses work on a machine without it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Union


class InvalidConfigError(Exception):
    """Raised when a config file cannot be parsed into the schema."""


@dataclasses.dataclass
class DatastoreSelection:
    """Which datastore implementation to use and its config file.

    ``config_path`` is resolved relative to the main config file's
    directory (reference: neural_lam/config.py:175-207).
    """

    kind: str
    config_path: str


@dataclasses.dataclass
class ManualStateFeatureWeighting:
    """Explicit per-variable loss weights; must cover every state var."""

    weights: dict[str, float]


@dataclasses.dataclass
class UniformFeatureWeighting:
    """Uniform ``1/n_features`` weighting."""


@dataclasses.dataclass
class OutputClamping:
    """Per-variable clamping limits for model output (physical units)."""

    lower: dict[str, float] = dataclasses.field(default_factory=dict)
    upper: dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainingConfig:
    """Training-specific configuration."""

    state_feature_weighting: Union[
        ManualStateFeatureWeighting, UniformFeatureWeighting
    ] = dataclasses.field(default_factory=UniformFeatureWeighting)
    output_clamping: OutputClamping = dataclasses.field(
        default_factory=OutputClamping
    )


@dataclasses.dataclass
class NeuralLAMConfig:
    """Top-level framework configuration."""

    datastore: DatastoreSelection
    training: TrainingConfig = dataclasses.field(
        default_factory=TrainingConfig
    )


_WEIGHTING_CLASSES = {
    "ManualStateFeatureWeighting": ManualStateFeatureWeighting,
    "UniformFeatureWeighting": UniformFeatureWeighting,
}


def _parse_weighting(
    data: dict,
) -> Union[ManualStateFeatureWeighting, UniformFeatureWeighting]:
    data = dict(data)
    tag = data.pop("__config_class__", None)
    if tag is None:
        # Untagged: infer from presence of explicit weights
        tag = (
            "ManualStateFeatureWeighting"
            if "weights" in data
            else "UniformFeatureWeighting"
        )
    try:
        cls = _WEIGHTING_CLASSES[tag]
    except KeyError as e:
        raise InvalidConfigError(
            f"Unknown state_feature_weighting class {tag!r} "
            f"(expected one of {sorted(_WEIGHTING_CLASSES)})"
        ) from e
    try:
        return cls(**data)
    except TypeError as e:
        raise InvalidConfigError(
            f"Invalid `state_feature_weighting` section for {tag}: {e}"
        ) from e


def config_from_dict(data: dict) -> NeuralLAMConfig:
    """Build a :class:`NeuralLAMConfig` from a plain (YAML) mapping."""
    try:
        ds = DatastoreSelection(**data["datastore"])
    except (KeyError, TypeError) as e:
        raise InvalidConfigError(
            f"Invalid or missing `datastore` section: {e}"
        ) from e

    raw_training = data.get("training") or {}
    if not isinstance(raw_training, dict):
        raise InvalidConfigError(
            "`training` section must be a mapping, got "
            f"{type(raw_training).__name__}"
        )
    training_data = dict(raw_training)
    weighting_data = training_data.pop("state_feature_weighting", None)
    clamping_data = training_data.pop("output_clamping", None)
    if training_data:
        raise InvalidConfigError(
            f"Unknown keys in `training` section: {sorted(training_data)}"
        )
    training = TrainingConfig()
    if weighting_data is not None:
        training.state_feature_weighting = _parse_weighting(weighting_data)
    if clamping_data is not None:
        try:
            training.output_clamping = OutputClamping(**clamping_data)
        except TypeError as e:
            raise InvalidConfigError(
                f"Invalid `output_clamping` section: {e}"
            ) from e
    return NeuralLAMConfig(datastore=ds, training=training)


def config_to_dict(config: NeuralLAMConfig) -> dict:
    """Serialise back to a YAML-ready mapping (round-trips with loader)."""
    out: dict = {
        "datastore": dataclasses.asdict(config.datastore),
        "training": {
            "state_feature_weighting": {
                "__config_class__": type(
                    config.training.state_feature_weighting
                ).__name__,
                **dataclasses.asdict(
                    config.training.state_feature_weighting
                ),
            },
            "output_clamping": dataclasses.asdict(
                config.training.output_clamping
            ),
        },
    }
    return out


def load_config(config_path: str | Path) -> NeuralLAMConfig:
    """Load a YAML config file."""
    import yaml

    with open(config_path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f) or {}
    return config_from_dict(data)


def load_config_and_datastore(config_path: str | Path):
    """Load config plus the datastore it selects.

    The datastore config path is resolved relative to the directory of
    the main config file (reference: neural_lam/config.py:175-207).
    """
    from .datastore import init_datastore

    config_path = Path(config_path)
    config = load_config(config_path)
    datastore_config_path = (
        config_path.parent / config.datastore.config_path
    )
    datastore = init_datastore(
        datastore_kind=config.datastore.kind,
        config_path=datastore_config_path,
    )
    return config, datastore
