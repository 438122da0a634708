"""Training / evaluation orchestrator, PyTorch port of
``liftreg_tpu/train/trainer.py``: per-phase datasets and loaders, model,
loss and optimizer from the config, warm start and resume, the train step
(forward, loss with pad weights, backward, Adam), no-grad validation with
segmentation metrics, the NCC score and folding, the epoch loop with
validation first and the best checkpoint saved on score, and the test
loop.

On the card the step runs the port's kernels. For the subspace models:
the lift into the encoder's input (``LiftRegSubspaceBackproj``; the model
without it resizes the projections), the warp and its coordinate gradient,
and with a bf16 basis the PCA expansion and its backward. For
``RegNet2D3D``: the lift, the warps of its inverse iteration and of the
attenuation volume with their coordinate and image gradients, and the
projector with its adjoint. Each step runs eagerly under
:func:`..device.f32_precision` (its f32 convolutions and products keep
f32 whatever the caller's TF32 flags). As in the JAX trainer:

* a non-finite loss rolls the step back on the card, parameters and
  optimizer state alike, with ``torch.where`` and no read of the loss on
  the host; the losses are buffered and read every ``log_flush_steps``
  steps, and a flush that finds a rolled-back step checkpoints the last
  finite state and raises ``SystemExit(42)``;
* ``step_timeout_s`` arms a watchdog that ends the process with
  ``os._exit(42)`` when a step blocks longer;
* training drops the last partial batch; evaluation pads it to the batch
  size (pad rows repeat the last sample and are dropped from the metrics).

Test mode draws 2D figures with matplotlib where it imports; where it does
not, it prints one line saying so and writes every other output: the
maps, the 3D volumes, the metrics.

It runs on the CUDA card unless the caller passes ``device="cpu"``;
without a card and without that it raises.

With ``n_devices`` N > 1 (or a ``mesh``) it is one rank of a data mesh
(:mod:`..parallel.mesh`; start the ranks with ``parallel.launch`` or
``main --n_devices N``) and computes what the JAX trainer computes on an
N-device mesh: every batch is padded to ``ceil(B / N) * N`` rows (pad
rows weighted 0 in the losses, but counted in batch-norm statistics and
RegNet2D3D's min-max normalisation, as under the JAX mesh), each rank
loads and runs its own rows, its losses are its shares of the global
weighted means (:class:`..losses.similarity.RankShare`), and after the
backward one ``all_reduce`` sums the flat f32 gradients and one the loss
scalars, so that Adam, the rollback of a non-finite step and the logged
losses are the same on every rank. Validation gathers the ranks' outputs
and every rank computes the metrics of the whole batch (the learning-rate
schedule reads them); rank 0 alone writes logs, figures and checkpoints,
and a resume or warm start is read on rank 0 and broadcast.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.dataset import (DataLoader, DeviceDataLoader, DeviceDatasetCache,
                            get_dataset, pad_batch)
from ..device import f32_precision, resolve_dtype
from ..losses.registration import get_loss
from ..losses.similarity import RankShare, ncc_loss
from ..models import get_model
from ..ops.fd import compute_jacobi_map
from ..ops.resample import warp_image
from ..parallel import mesh as mesh_lib
from ..pca import load_pca
from ..utils import visualize
from ..utils.checkpoint import resume_train, save_checkpoint
from ..utils.config import TrackedConfig
from ..utils.general import make_dir, parse_bool
from ..utils.io_utils import save_deformations, save_fig_3d
from ..utils.metrics import get_multi_metric
from .base import TrainerBase
from .optim import apply_updates, build_optimizer

__all__ = ["MetricsLogger", "RegistrationTrainer", "load_pca",
           "loss_and_grads"]


class MetricsLogger:
    """JSONL metrics log (``logs/metrics.jsonl``), mirrored to TensorBoard
    where ``torch.utils.tensorboard`` imports and ``LIFTREG_NO_TB`` is not
    ``1``."""

    def __init__(self, log_path):
        make_dir(log_path)
        self.jsonl = open(os.path.join(log_path, "metrics.jsonl"), "a")
        self.tb = None
        if os.environ.get("LIFTREG_NO_TB") == "1":
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(log_path, flush_secs=30)

    def add_scalar(self, tag, value, step):
        self.jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, float(value), int(step))

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class _NoLogger:
    """The logger of a rank other than 0, which writes no log."""

    def add_scalar(self, tag, value, step):
        pass

    def close(self):
        pass


# Reference-schema config keys this trainer accepts but does not consume,
# with the reason (the JAX trainer's list; _audit_config_keys reports them)
ACCEPTED_UNUSED_KEYS = {
    "train.dataloader.workers":
        "torch DataLoader worker counts of the reference; batches here are "
        "gathers from a card-resident cache or a host prefetch thread",
    "train.check_best_model_frequency":
        "never consumed by the reference either (cur_task_setting.json:28 "
        "is read by no code); val_frequency gates best-model checks",
    "dataset.load_training_data_into_memory":
        "splits are always memory-resident (and on the card when they fit); "
        "the reference used this to toggle blosc in-RAM caching",
    "train.gpu_ids":
        "device binding of the reference; the card here is the trainer's "
        "device argument (main.py -g)",
    "train.save_extra_3d_img":
        "never consumed by the reference either (no code reads it); the "
        "3D test artifacts saved are warped/target/phi",
}

# Keys consumed on code paths a given construction may not take (resume,
# test mode, model variants, CLI entry points); never warned about.
CONDITIONAL_KEYS = {
    "train.mode", "train.test_from", "train.continue_from",
    "train.continue_train", "train.continue_train_lr",
    "train.init_params_from",
    "train.model.latent_dim", "train.model.drr_feature_num",
    "train.model.mask_ct", "train.model.warp_taps_dtype",
    "train.model.pca_path", "train.model.inverse_iters",
    "train.network_class",
}

# Subtrees consumed only under a matching selector value
CONDITIONAL_PREFIXES = (
    "train.optim.lr_scheduler.plateau.",
    "train.optim.lr_scheduler.custom.",
    "train.optim.adam.",
    "exp.",
)

#: the JAX trainer's bound on the splits it keeps on the device ('auto')
_CACHE_BYTES = 6 * 2 ** 30


def _where_tree(cond, new, old):
    """``torch.where(cond, new, old)`` over matching nested dicts."""
    if isinstance(new, dict):
        return {k: _where_tree(cond, v, old[k]) for k, v in new.items()}
    return torch.where(cond, new, old)


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


def _tensors(tree):
    """The tensors of nested dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def loss_and_grads(model, loss, params, batch, pca, reg_factor, weights,
                   mesh):
    """One rank's forward, loss and backward of its rows of the batch,
    then the mesh's two reductions: one ``all_reduce`` of the gradients'
    flat f32 buffer and one of the loss scalars. ``weights`` is the
    rows' :class:`..losses.similarity.RankShare`; ``params`` the model's
    named parameters. Returns ``(losses, grads)`` of the global batch,
    detached, the same on every rank."""
    keys = list(params)
    with f32_precision():
        out = model(batch, pca)
        losses = loss(out, reg_factor, weights=weights)
        grads = torch.autograd.grad(losses["total_loss"],
                                    [params[k] for k in keys])
    del out
    with torch.no_grad():
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        grads = [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in grads]), grads)]
        values = mesh.all_reduce(torch.stack(
            [v.detach().float() for v in losses.values()]))
    return dict(zip(losses, values.unbind())), dict(zip(keys, grads))


class RegistrationTrainer(TrainerBase):
    """Construct from a ``ParameterDict`` or a plain nested dict with the
    ``cur_task_setting.json`` schema. ``device`` None means the CUDA card
    (raises without one); ``"cpu"`` runs the kernels' plain versions."""

    def __init__(self, setting, n_devices: Optional[int] = None,
                 device=None, mesh: Optional[mesh_lib.Mesh] = None):
        # the mesh is needed before the loaders, for the mesh-divisible
        # batch and this rank's rows of it
        self.mesh = mesh if mesh is not None \
            else mesh_lib.make_mesh(n_devices, device)
        self.device = self.mesh.device
        get = lambda d, k, default=None: (d[k] if k in d else default)  # noqa: E731
        # every key read is recorded, so that construction can report the
        # keys it accepted but never consumed
        if not isinstance(setting, TrackedConfig):
            setting = TrackedConfig(setting)
        train_setting = setting["train"]
        dataset_setting = setting["dataset"]
        self.mode = get(train_setting, "mode", "train")

        data_path = dataset_setting["data_path"]
        loader_cfg = train_setting["dataloader"]
        batch_size = loader_cfg["batch_size"]
        shuffle = get(loader_cfg, "shuffle", [True, True, False, False])

        dataset_cls = get_dataset(dataset_setting["dataset_class"])
        # the debug phase re-loads the train split: only with debug_on
        debug_on_early = bool(get(train_setting, "debug_on", False))
        phases = (["train", "val"] + (["debug"] if debug_on_early else [])
                  if self.mode == "train" else ["test"])
        self.datasets = {p: dataset_cls(data_path, phase=p,
                                        option=dataset_setting)
                         for p in phases}
        shuffle_idx = {"train": 0, "val": 1, "test": 3, "debug": 2}
        # train drops the partial final batch; eval phases pad it. Every
        # batch is padded to a multiple of the mesh's ranks
        self.batch_size = batch_size
        n_mesh = self.mesh.size
        self._target_b = -(-batch_size // n_mesh) * n_mesh
        self._local_b = self._target_b // n_mesh
        if self._target_b != batch_size and self.mesh.rank == 0:
            print(f"note: batch_size {batch_size} is not divisible by the "
                  f"{n_mesh}-rank mesh; padding every batch to "
                  f"{self._target_b}")
        shard = (self.mesh.rank, n_mesh)

        cache_cfg = get(train_setting, "cache_on_device", "auto")
        use_cache = (cache_cfg if isinstance(cache_cfg, bool)
                     else self._datasets_nbytes() < _CACHE_BYTES)
        self.loaders = {}
        for p in phases:
            drop_last = (p == "train"
                         and len(self.datasets[p]) >= batch_size)
            if use_cache:
                cache = DeviceDatasetCache(self.datasets[p], self.device)
                self.loaders[p] = DeviceDataLoader(
                    cache, batch_size=batch_size,
                    shuffle=bool(shuffle[shuffle_idx[p]]),
                    drop_last=drop_last, pad_to=self._target_b, shard=shard)
            else:
                self.loaders[p] = DataLoader(
                    self.datasets[p], batch_size=batch_size,
                    shuffle=bool(shuffle[shuffle_idx[p]]),
                    drop_last=drop_last, pad_to=self._target_b, shard=shard)

        self.img_sz = tuple(get(dataset_setting, "img_after_resize",
                                (160, 160, 160)))
        self.spacing = 1.0 / (np.asarray(self.img_sz) - 1)

        exp_folder = train_setting["output_path"]
        self.check_point_path = os.path.join(exp_folder, "checkpoints")
        self.record_path = os.path.join(exp_folder, "records")
        self.log_path = os.path.join(exp_folder, "logs")
        self.test_path = os.path.join(exp_folder, "tests")
        for p in (self.check_point_path, self.record_path, self.log_path,
                  self.test_path):
            make_dir(p)

        self.save_model_frequency = get(train_setting, "save_model_frequency", 5)
        # train.profile_dir: a torch.profiler trace of train steps
        # [3, 3 + profile_steps)
        self.profile_dir = get(train_setting, "profile_dir", "")
        self.profile_steps = get(train_setting, "profile_steps", 5)
        self._profiler = None
        # a step blocked longer than this many seconds ends the process
        # with code 42, for a supervisor to resume with --continue_from;
        # 0 disables
        self.step_timeout_s = float(get(train_setting, "step_timeout_s", 0))
        self._watchdog_started = False
        self._pending_losses = []
        self._loss_flush_steps = int(get(train_setting, "log_flush_steps", 8))
        self._last_flush_t = time.perf_counter()
        self.epochs = get(train_setting, "epoch", 100)
        self.save_3d_img = get(train_setting, "save_3d_img", False)
        self.val_frequency = get(train_setting, "val_frequency", 10)
        self.save_fig = get(train_setting, "save_fig", True)
        self.save_fig_frequency = get(train_setting, "save_fig_frequency", 2)
        self.debug_on = get(train_setting, "debug_on", False)
        self._no_fig_noted = False

        # Model + PCA
        model_cfg = train_setting["model"]
        model_cls = get_model(train_setting["model_class"])
        # the keyword arguments as the JAX trainer builds them: RegNet2D3D
        # takes no latent_dim, warp_taps_dtype or mask_ct, and only it
        # takes inverse_iters
        regnet = model_cls.__name__ == "RegNet2D3D"
        model_kwargs = {"img_sz": self.img_sz}
        if "latent_dim" in model_cfg and not regnet:
            model_kwargs["latent_dim"] = int(model_cfg["latent_dim"])
        if "drr_feature_num" in model_cfg:
            model_kwargs["drr_feature_num"] = int(model_cfg["drr_feature_num"])
        if model_cfg.get("compute_dtype") == "bfloat16":
            model_kwargs["compute_dtype"] = torch.bfloat16
        if not regnet and model_cfg.get("warp_taps_dtype") == "bfloat16":
            model_kwargs["warp_taps_dtype"] = torch.bfloat16
        if "mask_ct" in model_cfg and not regnet:
            model_kwargs["mask_ct"] = parse_bool(model_cfg["mask_ct"])
        if "inverse_iters" in model_cfg and regnet:
            model_kwargs["inverse_iters"] = int(model_cfg["inverse_iters"])
        for key in ("s2d_encoder", "fast_vjp"):
            if key in model_cfg:
                model_kwargs[key] = parse_bool(model_cfg[key])
        # the parameters are drawn from the seed, apart from the caller's
        # random stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(get(train_setting, "seed", 2021)))
            self.model = model_cls(**model_kwargs)
        self.model.to(self.device)
        if n_mesh > 1:
            # batch norm and RegNet2D3D's normalisation over the global batch
            mesh_lib.attach(self.model, self.mesh)
        pca_path = model_cfg.get("pca_path", "")
        pca_dtype = resolve_dtype(model_cfg.get("pca_dtype"), "pca_dtype")
        self.pca = load_pca(pca_path, dtype=pca_dtype, device=self.device) \
            if pca_path and os.path.isdir(pca_path) else None

        # Loss
        loss_cfg = train_setting["loss"]
        self.loss = get_loss(train_setting["loss_class"])(loss_cfg)

        # Optimizer / scheduler
        self.tx, self.base_lr, self.lr_scheduler = build_optimizer(
            train_setting["optim"])

        if len(self.datasets["train" if self.mode == "train" else "test"]) \
                == 0:
            raise RuntimeError(f"empty dataset for phase "
                               f"{'train' if self.mode == 'train' else 'test'}")
        self.params = dict(self.model.named_parameters())
        self.opt_state = self.tx.init(self.params)

        # Resume / test restore
        self.start_epoch = 0
        self.global_step = {p: 0 for p in ("train", "val", "debug", "test")}
        # warm start: parameters from a checkpoint (of either package),
        # everything else fresh. Checkpoints are read on rank 0, whose state
        # every rank takes below
        read = resume_train if self.mesh.rank == 0 else lambda path: None
        init_from = get(train_setting, "init_params_from", "")
        if self.mode == "train" and init_from:
            restored = read(init_from)
            if restored:
                self._load_params(init_from, restored[2]["params"])
                print(f"=> warm start: params from '{init_from}' "
                      "(epoch/optimizer/schedule state fresh)", flush=True)
        if self.mode == "train" and get(train_setting, "continue_train", False):
            path = train_setting["continue_from"]
            restored = read(path)
            if restored:
                self.start_epoch, self.global_step, state = restored
                self._load_params(path, state["params"])
                if "opt_state" in state:
                    self._load_opt_state(state["opt_state"])
                if state.get("lr_state"):
                    self.lr_scheduler.load_state_dict(state["lr_state"])
                continue_lr = get(train_setting, "continue_train_lr", -1)
                if continue_lr and continue_lr > 0:
                    self.lr_scheduler.base_lr = continue_lr
        elif self.mode == "test":
            path = train_setting["test_from"]
            restored = read(path)
            if restored:
                self.start_epoch, self.global_step, state = restored
                self._load_params(path, state["params"])
        self._take_rank0_state()

        self.cur_epoch = self.start_epoch
        self.iter_count = 0
        self.writer = None if self.mode != "train" \
            else MetricsLogger(self.log_path) if self.mesh.rank == 0 \
            else _NoLogger()
        self.config_warnings = self._audit_config_keys(setting)

    # ------------------------------------------------------------------
    def _take_rank0_state(self):
        """Every rank takes rank 0's parameters, buffers, optimizer state,
        schedule and counters (broadcast from rank 0)."""
        if self.mesh.group is None:
            return
        self.start_epoch, self.global_step, self.lr_scheduler = \
            self.mesh.broadcast_object(
                (self.start_epoch, self.global_step, self.lr_scheduler))
        for t in _tensors(self.model.state_dict()) \
                + _tensors(self.opt_state):
            self.mesh.broadcast(t)

    def _load_params(self, path, state_dict):
        """Tolerant restore: entries missing from the checkpoint keep their
        values; a checkpoint that matches fewer than half of the model's
        layers is another architecture and raises."""
        result = self.model.load_state_dict(
            {k: v for k, v in state_dict.items() if k in self.params},
            strict=False)
        layers = lambda keys: {k.rsplit(".", 1)[0] for k in keys}  # noqa: E731
        mine, theirs = layers(self.params), layers(state_dict)
        if len(mine & theirs) < len(mine) / 2:
            raise ValueError(
                f"checkpoint '{path}' parameter tree does not match the "
                f"model: checkpoint has {sorted(theirs - mine)[:4]}..., model "
                f"expects {sorted(mine - theirs)[:4]}...")
        unexpected = sorted(set(state_dict) - set(self.params))
        if result.missing_keys or unexpected:
            print("Warning !!! Error reading the whole model, loading the "
                  f"matching subset (missing from ckpt: "
                  f"{result.missing_keys}; unexpected in ckpt: {unexpected})")

    def _load_opt_state(self, saved):
        """The optimizer state of a checkpoint, onto the card, keeping any
        moment the checkpoint lacks at its fresh value."""
        saved = _to_device(saved, self.device)
        state = self.opt_state
        for key in ("mu", "nu"):
            if key in state and key in saved:
                state[key] = dict(state[key], **{
                    k: v for k, v in saved[key].items() if k in state[key]})
        if "count" in state and "count" in saved:
            state["count"] = saved["count"].to(torch.int32)
        state["hyperparams"] = dict(state["hyperparams"], **{
            k: v.float() for k, v in saved.get("hyperparams", {}).items()
            if k in state["hyperparams"]})

    def _audit_config_keys(self, tracked):
        """Warn about every config key that construction never read."""
        if not isinstance(tracked, TrackedConfig):
            return []
        warnings = []
        for path in sorted(tracked.unconsumed()):
            if path in CONDITIONAL_KEYS or \
                    any(path.startswith(p) for p in CONDITIONAL_PREFIXES):
                continue
            reason = ACCEPTED_UNUSED_KEYS.get(path)
            if reason is not None:
                warnings.append(f"config key '{path}' accepted but "
                                f"unused: {reason}")
            else:
                warnings.append(f"config key '{path}' is not recognized "
                                f"by this trainer and was ignored (typo?)")
        for w in warnings:
            print(f"Warning: {w}")
        return warnings

    def _datasets_nbytes(self):
        """Estimated bytes of all loaded splits (sample 0 x count)."""
        total = 0
        for ds in self.datasets.values():
            if len(ds) == 0:
                continue
            sample, _ = ds[0]
            total += len(ds) * sum(np.asarray(v).nbytes
                                   for v in sample.values())
        return total

    # ------------------------------------------------------------------
    def _weights(self, n_valid):
        """This rank's share of a padded batch whose first ``n_valid`` rows
        are real: pad rows carry no gradient."""
        w = (torch.arange(self._target_b, device=self.device)
             < n_valid).float()
        return RankShare(w[self.mesh.rows(self._target_b)],
                         float(min(n_valid, self._target_b)), self.mesh.size)

    def _train_step(self, batch, reg_factor, n_valid):
        """Forward, loss, backward and optimizer update of one batch (this
        rank's rows; ``n_valid`` real rows in the global batch); the update
        is kept only where the global loss is finite (decided on the
        card, the same on every rank). Returns the global losses as device
        scalars, with ``finite``."""
        losses, grads = loss_and_grads(
            self.model, self.loss, self.params, batch, self.pca, reg_factor,
            self._weights(n_valid), self.mesh)
        with torch.no_grad():
            updates, new_state = self.tx.update(grads, self.opt_state,
                                                self.params)
            new_params = apply_updates(self.params, updates)
            finite = torch.isfinite(losses["total_loss"])
            for k, p in self.params.items():
                p.copy_(torch.where(finite, new_params[k], p))
            self.opt_state = _where_tree(finite, new_state, self.opt_state)
        losses["finite"] = finite
        return losses

    @torch.no_grad()
    def _eval_step(self, batch):
        with f32_precision():
            out = self.model(batch, self.pca)
        res = {"warped": out["warped"], "phi": out["phi"],
               "target": out.get("target", batch.get("target"))}
        if "source_label" in batch:
            res["warped_label"] = warp_image(
                batch["source_label"], out["phi"], zero_boundary=True,
                scale_intensity=False, mode="nearest")
        if "warped_proj" in out:
            res["warped_proj"] = out["warped_proj"]
            res["target_proj"] = out["target_proj"]
        return res, out

    # ------------------------------------------------------------------
    def _iter_device(self, phase, epoch):
        """Iterate ``(device_batch, names)`` with one batch of lookahead,
        so that staging batch i+1 overlaps step i."""
        prev = None
        for data in self.loaders[phase]:
            cur = self.set_input(data, epoch)
            if prev is not None:
                yield prev
            prev = cur
        if prev is not None:
            yield prev

    def set_input(self, batch_names, epoch):
        """Pad a short batch to this rank's rows (the loaders' batches come
        padded) and put it on the trainer's device."""
        batch, names = batch_names
        b = next(v.shape[0] for v in batch.values()
                 if hasattr(v, "ndim") and v.ndim > 0)
        if b != self._local_b:
            batch, _ = pad_batch(batch, self._local_b)
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in batch.items()}
        return batch, names

    def _compute_metrics(self, eval_out, batch):
        """dice/iou/recall/precision + score + folding."""
        metrics = {}
        if "warped_label" in eval_out and "target_label" in batch:
            info = get_multi_metric(eval_out["warped_label"].cpu().numpy(),
                                    batch["target_label"].cpu().numpy(),
                                    verbose=False)
            for k, v in info["batch_avg_res"].items():
                metrics[k] = v[0, 1] if v.shape[1] > 1 else v[0, 0]
        # reference quirk: score = 1 - ncc_loss/B, over the batch's real
        # rows (the JAX trainer's val_step drops the pad rows first)
        b = eval_out["warped"].shape[0]
        metrics["score"] = 1.0 - float(
            ncc_loss(eval_out["warped"], eval_out["target"])) / b
        folding_sum, folding_count = compute_jacobi_map(
            eval_out["phi"], self.spacing, crop_boundary=True, use_01=False)
        metrics["folding_sum"] = folding_sum
        metrics["folding_count"] = folding_count
        return metrics

    def _maybe_profile(self):
        if not self.profile_dir or self.mesh.rank != 0:
            return
        step = self.global_step["train"]
        if step == 3 and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.__enter__()
        elif self._profiler is not None and step >= 3 + self.profile_steps:
            self._stop_profile()

    def _stop_profile(self):
        self._profiler.__exit__(None, None, None)
        make_dir(self.profile_dir)
        path = os.path.join(self.profile_dir, "trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        print(f"profiler trace written to {path}")

    def _start_watchdog(self):
        if self.step_timeout_s <= 0 or self._watchdog_started:
            return
        import threading
        self._heartbeat = time.monotonic()
        self._in_step = False
        self._watch_scale = 1.0

        def watch():
            while True:
                time.sleep(max(self.step_timeout_s / 4, 1.0))
                budget = self.step_timeout_s * self._watch_scale
                if self._in_step and (time.monotonic() - self._heartbeat
                                      > budget):
                    print(f"WATCHDOG: device call exceeded "
                          f"{budget:.0f}s — likely a hung "
                          f"accelerator; exiting 42 (resume with "
                          f"--continue_from)", flush=True)
                    os._exit(42)

        threading.Thread(target=watch, daemon=True).start()
        self._watchdog_started = True

    def _watch(self, scale=1.0):
        """Arm the watchdog around a call that may block on the device;
        ``scale`` multiplies ``step_timeout_s``."""
        if self._watchdog_started:
            self._watch_scale = scale
            self._heartbeat = time.monotonic()
            self._in_step = True

    def _unwatch(self):
        if self._watchdog_started:
            self._in_step = False

    def step(self, batch, names):
        """One train step. The losses are not read here: they are buffered
        on the card and flushed every ``log_flush_steps`` steps and at the
        end of the epoch."""
        self._start_watchdog()
        self._maybe_profile()
        reg_factor = self.loss.factor(self.cur_epoch)
        self.iter_count += 1
        # the first step includes the kernels' build
        self._watch(scale=60.0 if self.iter_count == 1 else 1.0)
        try:
            losses = self._train_step(batch, reg_factor, len(names))
        finally:
            # a raising step must not leave the watchdog armed
            self._unwatch()
        self._pending_losses.append((self.global_step["train"], losses))
        if len(self._pending_losses) >= self._loss_flush_steps:
            self._flush_losses()
        return losses

    def _flush_losses(self):
        """Read back and log the buffered step losses (one host read)."""
        if not self._pending_losses:
            return
        self._watch(scale=max(1.0, float(len(self._pending_losses))))
        try:
            keys = list(self._pending_losses[0][1])
            stacked = torch.stack([
                torch.stack([l[k].float() for k in keys])
                for _, l in self._pending_losses]).cpu().tolist()
        finally:
            self._unwatch()
        now = time.perf_counter()
        per_step_ms = ((now - self._last_flush_t) * 1000.0
                       / len(self._pending_losses))
        self._last_flush_t = now
        bad_step = None
        for (gstep, _), values in zip(self._pending_losses, stacked):
            losses = dict(zip(keys, values))
            for k, v in losses.items():
                self.writer.add_scalar(f"Train/{k}", v, gstep)
            self.writer.add_scalar("Train/step_time_ms", per_step_ms, gstep)
            if bad_step is None and not bool(losses.get("finite", True)):
                bad_step = gstep
        self._pending_losses.clear()
        if bad_step is not None:
            self._halt_non_finite(bad_step)

    def _halt_non_finite(self, gstep):
        """A train step gave a non-finite loss. Its update was rolled back
        in the step, so the parameters and optimizer state are the last
        finite ones: checkpoint them and exit with code 42, for a
        supervisor to resume with --continue_from."""
        print(f"FATAL: non-finite train loss at global step {gstep}; "
              f"update rolled back, checkpointing last finite state and "
              f"halting (exit 42, resumable via --continue_from "
              f"{os.path.join(self.check_point_path, 'nan_halt_checkpoint.ckpt')})")
        self.save_model("nan_halt", is_best=False)
        raise SystemExit(42)

    def val_step(self, batch, names, phase, save_fig=False, debug_on=False):
        eval_out, out = self._eval_step(batch)
        nv = len(names)
        losses = None
        if phase == "val" and debug_on:
            # the global means over the real rows
            with torch.no_grad():
                losses = self.loss(out, self.loss.factor(self.cur_epoch),
                                   weights=self._weights(nv))
                values = self.mesh.all_reduce(torch.stack(
                    [v.float() for v in losses.values()]))
            losses = dict(zip(losses, values.tolist()))
        # the ranks' rows of the outputs, and of what the metrics and
        # figures read of the batch
        eval_out = {k: self.mesh.gather_rows(v) for k, v in eval_out.items()}
        keys = ("source", "target", "source_label", "target_label") \
            if save_fig else ("target_label",)
        batch = {k: self.mesh.gather_rows(batch[k]) for k in keys
                 if k in batch}
        # drop the pad rows: metrics, figures and saved maps cover only the
        # real samples
        eval_out = {k: v[:nv] for k, v in eval_out.items()}
        batch = {k: (v[:nv] if hasattr(v, "ndim") and v.ndim > 0
                     and v.shape[0] > nv else v) for k, v in batch.items()}
        metrics = self._compute_metrics(eval_out, batch)
        if save_fig and self.mesh.rank == 0:
            self._save_fig(eval_out, batch, names, phase)
            if self.save_3d_img:
                self._save_fig_3d(eval_out, names, phase)
                if phase == "test":
                    save_deformations(eval_out["phi"].cpu().numpy(), names,
                                      self.test_path)
        return losses, metrics

    def _save_fig(self, eval_out, batch, names, phase):
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            if not self._no_fig_noted:
                print("matplotlib is not installed: no 2D figures (PNG) are "
                      "written; the maps, 3D volumes and metrics are",
                      flush=True)
                self._no_fig_noted = True
            return
        base = self.test_path if phase == "test" else self.record_path
        visual_param = {
            "save_fig": True,
            "save_fig_path": base,
            "save_fig_path_byname": os.path.join(base, "byname"),
            "save_fig_path_byiter": os.path.join(base, "byiter"),
            "save_fig_num": 4,
            "pair_name": names,
            "iter": f"{phase}_iter_{self.cur_epoch:06d}",
        }
        host = lambda t: None if t is None else t.float().cpu().numpy()  # noqa: E731
        visualize.show_current_images(
            self.iter_count, iS=host(batch["source"]),
            iT=host(batch["target"]), iW=host(eval_out["warped"]),
            iSL=host(batch.get("source_label")),
            iTL=host(batch.get("target_label")),
            iWL=host(eval_out.get("warped_label")),
            phiWarped=host(eval_out["phi"]), visual_param=visual_param)

    def _save_fig_3d(self, eval_out, names, phase):
        path = os.path.join(
            self.record_path if self.mode == "train" else self.test_path, "3D")
        make_dir(path)
        suffix = (f"_{phase}_iter_{self.cur_epoch}" if self.mode == "train"
                  else f"_{phase}")
        save_fig_3d(eval_out["warped"].cpu().numpy()[:, 0], path, names,
                    suffix + "_warped", spacing=self.spacing)
        if eval_out.get("target") is not None:
            save_fig_3d(eval_out["target"].cpu().numpy()[:, 0], path, names,
                        suffix + "_target", spacing=self.spacing)

    def _set_lr(self):
        lr = self.lr_scheduler.lr
        self.opt_state["hyperparams"]["learning_rate"] = torch.tensor(
            float(lr), dtype=torch.float32, device=self.device)
        return lr

    def save_model(self, prefix, is_best):
        """Write a checkpoint (rank 0 only); returns its path, or None on
        the other ranks."""
        if self.mesh.rank != 0:
            return None
        state = {"epoch": self.cur_epoch, "params": self.model.state_dict(),
                 "opt_state": self.opt_state,
                 "global_step": self.global_step,
                 "lr_state": self.lr_scheduler.state_dict()}
        return save_checkpoint(state, is_best, self.check_point_path, prefix)

    # ------------------------------------------------------------------
    def run(self):
        if self.mode == "train":
            self._train_model()
        else:
            self._test_model()

    def _train_model(self):
        since = time.time()
        best_score, best_epoch, best_metrics = -1.0, -1, {}
        val_score = 0.0

        for epoch in range(self.start_epoch, self.epochs + 1):
            self.cur_epoch = epoch
            lr = self._set_lr()
            self.writer.add_scalar("lr", lr, epoch)

            if epoch % self.val_frequency == 0:
                save_fig = self.save_fig and epoch % self.save_fig_frequency == 0
                running_m, running_l, nb = {}, {}, 0
                for data in self.loaders["val"]:
                    batch, names = self.set_input(data, epoch)
                    losses, metrics = self.val_step(
                        batch, names, "val", save_fig, debug_on=self.debug_on)
                    save_fig = False
                    nb += 1
                    for k, v in metrics.items():
                        running_m[k] = running_m.get(k, 0.0) + v
                    if self.debug_on and losses:
                        for k, v in losses.items():
                            running_l[k] = running_l.get(k, 0.0) + v
                    self.global_step["val"] += 1
                for k, v in running_m.items():
                    self.writer.add_scalar(f"Val_metrics/{k}", v / nb, epoch)
                for k, v in running_l.items():
                    self.writer.add_scalar(f"Val_loss/{k}", v / nb, epoch)

                val_score = running_m.get("score", 0.0) / max(nb, 1)
                if val_score > best_score:
                    best_score, best_epoch = val_score, epoch
                    self.save_model("", is_best=True)
                    best_metrics = {k: v / nb for k, v in running_m.items()}

            # the first window's per-step time starts here, after the val
            self._last_flush_t = time.perf_counter()
            for batch, names in self._iter_device("train", epoch):
                self.global_step["train"] += 1
                self.step(batch, names)
            self._flush_losses()

            if self.debug_on and self.save_fig and \
                    epoch % self.save_fig_frequency == 0:
                running_m, nb, save_fig = {}, 0, True
                for data in self.loaders["debug"]:
                    batch, names = self.set_input(data, epoch)
                    _, metrics = self.val_step(batch, names, "debug",
                                               save_fig, self.debug_on)
                    save_fig = False
                    nb += 1
                    for k, v in metrics.items():
                        running_m[k] = running_m.get(k, 0.0) + v
                    self.global_step["debug"] += 1
                for k, v in running_m.items():
                    self.writer.add_scalar(f"Debug/{k}", v / nb, epoch)

            self.lr_scheduler.step(val_score)

            if epoch % self.save_model_frequency == 0:
                prefix = f"epoch_{epoch}" if self.debug_on else "latest"
                self.save_model(prefix, is_best=False)

        if self._profiler is not None:
            self._stop_profile()
        elapsed = time.time() - since
        if self.mesh.rank == 0:
            print("Training complete in {:.0f}m {:.0f}s".format(
                elapsed // 60, elapsed % 60))
            print("Best val score : {:4f} is at epoch {}".format(
                best_score, best_epoch))
            print(f"Best val metrics:{best_metrics}")
        for k, v in best_metrics.items():
            self.writer.add_scalar(f"Best_metrics/{k}", v, 0)
        self.writer.close()

    def _test_model(self):
        since = time.time()
        running, nb = {}, 0
        for data in self.loaders["test"]:
            batch, names = self.set_input(data, self.cur_epoch)
            _, metrics = self.val_step(batch, names, "test", True)
            nb += 1
            for k, v in metrics.items():
                running[k] = running.get(k, 0.0) + v
        elapsed = time.time() - since
        if self.mesh.rank == 0:
            for k, v in running.items():
                print(f"{k}: {v / max(nb, 1)}")
            print("Testing complete in {:.0f}m {:.0f}s".format(
                elapsed // 60, elapsed % 60))
