"""The check against the plain reference: sound runs of the program on the
CPU read ``correct``; with the timed path broken underneath, the rest of
the run unchanged, they do not. One cell on one chip has no exchange
between chips, so that fault does not apply."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from conftest import SEED


def _half(t):
    return t[: t.shape[0] // 2]


def state_unchanged_train(mp):
    mp.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def half_batch_train(mp):
    from neural_lam_tpu_torch.trainer import Trainer

    loss = Trainer._loss
    mp.setattr(Trainer, "_loss", lambda self, i, t, f: loss(self, _half(i), _half(t), _half(f)))


def answer_altered_train(mp):
    from neural_lam_tpu_torch.trainer import Trainer

    loss = Trainer._loss
    mp.setattr(Trainer, "_loss", lambda self, *batch: loss(self, *batch) * (1 + 1e-3))


def state_unchanged_forecast(mp):
    from neural_lam_tpu_torch.models.graph_base import BaseGraphModel

    mp.setattr(BaseGraphModel, "step", lambda self, prev, prev_prev, forcing: (prev.float(), None))


def half_batch_forecast(mp):
    from neural_lam_tpu_torch.models.forecaster import ARForecaster

    forward = ARForecaster.forward

    def half(self, init, forcing, boundary, params=None):
        out, std = forward(self, _half(init), _half(forcing), _half(boundary), params)
        return torch.cat((out, out)), std

    mp.setattr(ARForecaster, "forward", half)


def answer_altered_forecast(mp):
    from neural_lam_tpu_torch.models.forecaster import ARForecaster

    forward = ARForecaster.forward

    def altered(self, *args, **kwargs):
        out, std = forward(self, *args, **kwargs)
        out = out.clone()
        out[0, -1, 0, 0] += 1.0
        return out, std

    mp.setattr(ARForecaster, "forward", altered)


FAULTS = {
    "graphlam_train_f32": (state_unchanged_train, half_batch_train, answer_altered_train),
    "hilam_train_f32": (state_unchanged_train, half_batch_train, answer_altered_train),
    "graphlam_forecast_f32": (state_unchanged_forecast, half_batch_forecast,
                              answer_altered_forecast),
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_runs_are_correct(tiny_root, cell):
    out = harness.run_cell(tiny_root, cell, SEED, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items()) for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = harness.run_cell(tiny_root, cell, SEED, 0.3, False, device="cpu")
    assert not out["correct"], out["checks"]
