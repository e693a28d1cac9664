"""Test-phase evaluation: metric tables, heatmaps, spatial maps, examples.

Counterpart of ``neural_lam_tpu/evaluation.py`` (reference: the
``test_step`` / ``on_test_epoch_end`` artifact pipeline,
neural_lam/models/module.py:511-962):

- per-(unroll step, variable) MSE/MAE accumulated over the split,
  converted to RMSE and rescaled to physical units by the state std,
- per-grid-node spatial loss maps averaged over the split,
- CSV tables + heatmap/spatial figures via ``vis``,
- example prediction/target map plots for the first samples.

Each batch runs on the trainer's device, on CUDA as a CUDA graph per
batch shape and route (``utils.cuda_graph.CapturedFunction``, the
counterpart of the JAX package's jitted ``eval_batch``), on the CPU
eagerly; its per-sample rows leave the device after the batch, so nothing
of size ``(samples, steps, grid)`` stays there. The figures need
matplotlib: where it is not installed, the metrics and the CSV tables are
written, and one line on stderr names the figures that were not drawn.

Over a process group each rank sums its own rows, one merge of the sums
and counts per pass gives every rank the same metrics
(``Trainer._merge_host_sums``), and rank 0 alone writes the artifacts
and plots the examples, from its own block, which holds the globally
first samples (``neural_lam_tpu/evaluation.py:126-160``, ``:258``).

Under spatial partitioning (``Trainer(spatial_shards=...)``) each rank
runs its shard: the batch's metrics are summed over the spatial group
inside the batch function, the per-node loss map is gathered from the
slabs and cut to the grid there too, and the forecasts rank 0 plots are
gathered by the ranks of its spatial group (the JAX package's sharded
``forward`` returns the unpadded global prediction, ``:89-95``).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from .loggers import BaseLogger, NullLogger
from .utils import distributed
from .utils.cuda_graph import CapturedFunction


def save_metrics_csv(errors: np.ndarray, datastore, path, step_length_hours=None) -> None:
    """Write the (pred_steps, n_vars) error table as CSV, same artifact
    as the reference test phase (reference: models/module.py:796-804).
    It lives here rather than in ``vis`` (which re-exports it), so that
    the tables are written where matplotlib is not installed."""
    errors = np.asarray(errors)
    var_names = datastore.get_vars_names("state")
    if step_length_hours is None:
        step_length_hours = datastore.step_length.total_seconds() / 3600
    with open(path, "w", encoding="utf-8") as f:
        f.write("lead_time_h," + ",".join(var_names) + "\n")
        for i, row in enumerate(errors):
            lead = step_length_hours * (i + 1)
            f.write(f"{lead:g}," + ",".join(f"{v:.6g}" for v in row) + "\n")


def _write_prediction_gif(vis, pred_t, target_t, datastore, var_name, path) -> None:
    """Animate prediction vs target over lead time as a GIF
    (reference: module.py:600-768 ``--create_gif``)."""
    from PIL import Image

    vmin = float(min(pred_t.min(), target_t.min()))
    vmax = float(max(pred_t.max(), target_t.max()))
    frames = []
    for t in range(pred_t.shape[0]):
        fig = vis.plot_prediction(
            pred_t[t], target_t[t], datastore,
            title=f"{var_name} t={t + 1}", vrange=(vmin, vmax),
        )
        fig.canvas.draw()
        frames.append(Image.fromarray(np.asarray(fig.canvas.buffer_rgba())).convert("RGB"))
        vis.plt.close(fig)
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=500, loop=0)


def _import_vis():
    """The plotting module, or ``None`` with the reason where matplotlib
    is not installed."""
    try:
        from . import vis
    except ImportError as e:
        return None, str(e)
    return vis, None


def make_eval_batch(trainer) -> CapturedFunction:
    """The test evaluation's batch ``(init, target, forcing) -> ((loss
    (B, T), mse, mae and wmae tables (B, T, d), spatial loss (B, T, N)),
    prediction (B, T, N, d))`` on ``trainer``'s device, in standardized
    units: the counterpart of the JAX package's jitted ``eval_batch``
    (``neural_lam_tpu/evaluation.py:84-121``). A CUDA graph per batch
    shape and route on the card, whose replays return clones, eager on the
    CPU. Under spatial partitioning the prediction is this shard's slab."""

    def eval_batch(init, target, forcing):
        init_s, target_s, forcing_s = trainer._standardize(init, target, forcing)
        prediction, pred_std = trainer._local_fc(init_s, forcing_s, target_s)
        if pred_std is None:
            pred_std = trainer.per_var_std
        # the loss (B, T) and the mse, mae and wmae tables (B, T, d)
        metrics = trainer._spatial_sum(
            [trainer.masked_metric(trainer.args.loss, prediction, target_s, pred_std)]
            + [trainer.masked_metric(name, prediction, target_s, pred_std, sum_vars=False)
               for name in ("mse", "mae", "wmae")]
        )
        # per grid node, summed over vars, per sample so that padded
        # tail rows can be dropped (reference: module.py:571-582)
        spatial = trainer.loss_fn(
            prediction, target_s, pred_std, mask=None,
            average_grid=False, sum_vars=True,
        )  # (B, T, N)
        if trainer.spatial is not None:
            spatial = trainer.spatial.gather_grid(spatial.unsqueeze(-1)).squeeze(-1)
        return (*metrics, spatial), prediction

    return CapturedFunction(eval_batch, trainer.forecaster, trainer.device,
                            eager=trainer._eager_inference())


def run_test_evaluation(
    trainer,
    loader,
    datastore,
    run_dir: str | Path,
    logger: Optional[BaseLogger] = None,
    split: str = "test",
    n_example_pred: int = 1,
    spatial_steps: tuple[int, ...] = (1, -1),
    create_gif: bool = False,
    metrics_watch: Optional[list[str]] = None,
    var_leads_metrics_watch: Optional[dict] = None,
) -> dict:
    """Full evaluation of ``trainer``'s forecaster with artifacts under
    ``run_dir``; returns the scalar metrics dict."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    logger = logger or NullLogger()
    is_rank_zero = distributed.rank() == 0
    # the ranks of rank 0's spatial group gather the forecasts it plots
    gathers = trainer.spatial is not None and trainer.data_index == 0
    if not (is_rank_zero or gathers):
        n_example_pred = 0
    vis, no_vis = _import_vis()
    skipped: list[str] = []
    if vis is None and n_example_pred > 0:
        skipped.append(f"{split} example predictions")
        n_example_pred = 0

    stats = datastore.get_standardization_dataarray(category="state")
    state_mean = np.asarray(stats["state_mean"], np.float32)
    state_std = np.asarray(stats["state_std"], np.float32)

    eval_batch = make_eval_batch(trainer)

    sums: dict[str, np.ndarray] = {}
    count = 0
    example_plotted = 0
    pred_steps = None
    var_names = datastore.get_vars_names("state")
    var_units = datastore.get_vars_units("state")
    for batch in loader:
        device_batch, real = trainer.device_put_batch(batch)
        per_batch, prediction = eval_batch(*device_batch)
        if pred_steps is None:
            pred_steps = int(per_batch[0].shape[1])
        for key, val in zip(("loss", "mse", "mae", "wmae", "spatial"), per_batch):
            rows = val[:real].cpu().numpy()
            sums[key] = sums.get(key, 0) + rows.sum(axis=0)
        count += real

        # Example prediction plots from the first batch(es)
        # (reference: module.py:584-768)
        n_plot = min(n_example_pred - example_plotted, real) if n_example_pred > 0 else 0
        if n_plot > 0:
            pred_local = prediction[:n_plot]
            if trainer.spatial is not None:
                pred_local = trainer.spatial.gather_grid(pred_local)
            pred_local = pred_local.cpu().numpy()
        for i in range(n_plot if is_rank_zero else 0):
            ex = example_plotted + i  # global example index for naming
            pred_phys = pred_local[i] * state_std + state_mean  # (T, N, d)
            target_phys = np.asarray(batch[1])[i]
            t_last = pred_steps - 1
            for v, (name, unit) in enumerate(zip(var_names, var_units)):
                fig = vis.plot_prediction(
                    pred_phys[t_last, :, v], target_phys[t_last, :, v], datastore,
                    title=f"{name} ({unit}), t={(t_last + 1)} steps",
                )
                logger.log_image(f"{split}_example_{ex}/{name}", fig, step=t_last + 1)
                vis.plt.close(fig)
                if create_gif:
                    _write_prediction_gif(
                        vis, pred_phys[:, :, v], target_phys[:, :, v], datastore, name,
                        run_dir / f"{split}_example_{ex}_{name}.gif",
                    )
        example_plotted += n_plot

    if count == 0 or pred_steps is None:
        raise ValueError(
            f"{split} loader yielded no batches — the split's time axis "
            "is too short for the requested ar_steps/forcing window "
            "(dataset length formula: T - (max(2, past) + ar + future) + 1)"
        )
    # one merge of the ranks' sums and counts per pass
    sums, count = trainer._merge_host_sums(sums, count)

    mean_loss_per_step = sums["loss"] / count  # (T,)
    mse_per_step_var = sums["mse"] / count  # (T, d)
    mae_per_step_var = sums["mae"] / count
    spatial_mean = sums["spatial"] / count  # (T, N)

    # Physical-unit RMSE/MAE (reference: module.py:837-858)
    rmse_phys = np.sqrt(mse_per_step_var) * state_std
    mae_phys = mae_per_step_var * state_std

    metrics = {f"{split}_loss": float(mean_loss_per_step.mean())}
    for s in trainer.args.val_steps_to_log:
        if s <= len(mean_loss_per_step):
            metrics[f"{split}_loss_unroll{s}"] = float(mean_loss_per_step[s - 1])

    # Promote watched (metric, variable, lead time) scalars
    # (reference: module.py:806-817), with the per-epoch promoter's units:
    # rmse/mae physical, mse standardized, wmae as computed
    if metrics_watch:
        tables = {
            "rmse": rmse_phys,
            "mae": mae_phys,
            "mse": mse_per_step_var,
            "wmae": sums["wmae"] / count,
        }
        for watched in metrics_watch:
            key = watched.split("_")[-1]
            table = tables.get(key)
            if table is None:
                continue
            for var, leads in (var_leads_metrics_watch or {}).items():
                if var not in var_names:
                    continue
                v = var_names.index(var)
                for lead in leads:
                    if 1 <= lead <= table.shape[0]:
                        metrics[f"{split}_{key}_{var}_step{lead}"] = float(table[lead - 1, v])

    # the artifacts: rank 0's, the metrics being the same on every rank
    if not is_rank_zero:
        return metrics
    save_metrics_csv(rmse_phys, datastore, run_dir / f"{split}_rmse.csv")
    save_metrics_csv(mae_phys, datastore, run_dir / f"{split}_mae.csv")
    if vis is None:
        skipped += [f"{split}_rmse_heatmap.pdf", f"{split}_mae_heatmap.pdf"]
    else:
        for name, table in (("rmse", rmse_phys), ("mae", mae_phys)):
            fig = vis.plot_error_heatmap(table, datastore, title=f"{split} {name.upper()}")
            fig.savefig(run_dir / f"{split}_{name}_heatmap.pdf")
            logger.log_image(f"{split}_{name}_heatmap", fig)
            vis.plt.close(fig)

    for step in spatial_steps:
        idx = step - 1 if step > 0 else pred_steps + step
        if not 0 <= idx < pred_steps:
            continue
        if vis is None:
            skipped.append(f"{split}_spatial_loss_step{idx + 1}.pdf")
            continue
        fig = vis.plot_spatial_error(
            spatial_mean[idx], datastore, title=f"{split} spatial loss, step {idx + 1}"
        )
        fig.savefig(run_dir / f"{split}_spatial_loss_step{idx + 1}.pdf")
        logger.log_image(f"{split}_spatial_loss", fig, step=idx + 1)
        vis.plt.close(fig)
    np.save(run_dir / "mean_spatial_loss.npy", spatial_mean)

    (run_dir / f"{split}_metrics.json").write_text(
        json.dumps(metrics, indent=2), encoding="utf-8"
    )
    logger.log_metrics(metrics)
    if skipped:
        print(
            f"evaluation: figures not drawn ({no_vis}): {', '.join(skipped)}",
            file=sys.stderr,
        )
    return metrics
