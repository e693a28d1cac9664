"""Per-state-feature loss weighting.

Counterpart of ``neural_lam_tpu/loss_weighting.py``. Behavioural parity with the reference weighting module
(reference: neural_lam/loss_weighting.py:12-120): a manual weighting
must cover the datastore's state variables exactly (no extras, no
holes), and the uniform fallback assigns ``1/n`` to each of the ``n``
state features. The implementation here resolves straight to a numpy
vector in datastore feature order, which the trainer multiplies into
the standardized per-variable std.
"""

from __future__ import annotations

import numpy as np

from .config import (
    ManualStateFeatureWeighting,
    NeuralLAMConfig,
    UniformFeatureWeighting,
)
from .datastore.base import BaseDatastore


def get_state_feature_weighting(
    config: NeuralLAMConfig, datastore: BaseDatastore
) -> np.ndarray:
    """Resolve the configured weighting into a ``(n_state,)`` f32 vector,
    ordered like ``datastore.get_vars_names("state")``."""
    spec = config.training.state_feature_weighting
    names = list(datastore.get_vars_names(category="state"))
    if isinstance(spec, ManualStateFeatureWeighting):
        weights = _resolve_manual_weights(spec.weights, names)
    elif isinstance(spec, UniformFeatureWeighting):
        weights = np.full(len(names), 1.0 / max(len(names), 1))
    else:
        raise NotImplementedError(
            f"No weighting rule for config type {type(spec).__name__}"
        )
    return np.asarray(weights, dtype=np.float32)


def _resolve_manual_weights(
    weight_table: dict[str, float], state_var_names: list[str]
) -> np.ndarray:
    """Order a name->weight table by the datastore's state variables.

    The table must be an exact cover of the state variables
    (reference: loss_weighting.py:37-52 enforces the same invariant).
    """
    given = set(weight_table)
    expected = set(state_var_names)
    if given != expected:
        problems = []
        unweighted = sorted(expected - given)
        if unweighted:
            problems.append(f"no weight given for {unweighted}")
        unknown = sorted(given - expected)
        if unknown:
            problems.append(f"weights name unknown variables {unknown}")
        raise ValueError(
            "Manual state-feature weighting must map every datastore "
            f"state variable (expected exactly {sorted(expected)}): "
            + "; ".join(problems)
        )
    return np.array([weight_table[name] for name in state_var_names])
