"""The train and eval steps and the ``SemanticSeg`` trainer of the port.

Counterpart of ``hdenseformer_tpu/train/loop.py``. One train step
(``make_train_step``): the model in training mode, the forward (dropout
drawn from the caller's ``torch.Generator``), the loss with the batch's
optional pad-and-mask ``weight``, ``backward``, the optimizer's step, and
dice and the confusion matrix on the fp32 logits of head 0. The metrics
stay tensors on the device: the step never waits for the card. Precision
is the model's: bf16 compute with fp32 parameters when it is built with
``dtype=torch.bfloat16``, fp32 heads and loss; rematerialisation is the
model's ``remat``. A BatchNorm model (the DAUNet family, TransBTS) updates
its running statistics in the step's one training-mode forward, once an
optimizer step, as JAX's ``mutable`` apply does; the eval step and
inference read them in eval mode, as JAX's ``train=False``, and the port's
checkpoints carry them as buffers of the model's state dict.

``SemanticSeg`` keeps the JAX class's constructor knobs and ``trainer()``
keyword arguments, its epoch loop (per-epoch LR schedule, validation,
EarlyStopping on val_dice with patience 30, a metric-named checkpoint
whenever val_dice improves, newest-3 retention) and its metric drains
(every 10 global steps and at epoch end; no per-step host sync). On one
device:

- each batch is padded to the batch size by ``pad_and_mask_batch`` (cyclic
  repeats, weight 0), so every step has one shape;
- the dropout generator lives on the model's device and is seeded from
  (seed, optimizer step) before each step (``step_seed``), as JAX's key is
  ``fold_in(PRNGKey(seed), step)``: a resumed run draws the masks of an
  unbroken one;
- a 2-D ``input_shape`` trains on 2-D slice cases through the 2-D
  transform table (``transform_list_2d``, JAX's numbering; the validation
  subset [1, 2, 10]), whose augmentations (``data/augment2d.py``) run on the
  host;
- ``ex_pre_trained`` (the smp-style 2-D baselines only) loads a local
  torchvision-format ResNet state dict (``.pth`` or ``.npz``) into the
  encoder after the seeded initialisation (``models.unet2d.
  load_torch_resnet_encoder``); ``True`` would download ImageNet weights in
  the reference, so it raises, as JAX's does;
- with ``device_augment`` (3-D only) the loader ships raw channels-last
  cases (``RawChannelsLast``) and ``data/augment_device.augment_batch_3d``
  runs inside the step on the card, drawing from a second generator seeded
  from (seed, 777, step) (``augment_seed``; JAX's
  ``fold_in(fold_in(key, 777), step)``): the dropout masks are those of a
  run without it, and a resumed run replays the unbroken run's draws;
- ``load_pretrained`` reads the port's checkpoints and the JAX package's
  (flax msgpack; ``train/checkpoint.py``), weights and, with
  ``ckpt_point``, the optimizer state, epoch and step;
- as in JAX, a resumed run builds a fresh LR scheduler and steps it from
  epoch 0, so its rate restarts;
- the knob ``device`` is the torch device (None: the GPU, raising without
  one), where JAX's selects a device count; ``use_pallas`` maps to
  ``get_net``'s ``use_kernels``; ``norm_barrier`` and ``shift_pack`` are
  XLA knobs, accepted and ignored.

Not ported: more than one device (``NotImplementedError``, ROADMAP.md
queue 1 item 6).
"""
from __future__ import annotations

import math
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hdenseformer_tpu_torch.data.augment2d import (
    RandomAdjust2D,
    RandomDistort2D,
    RandomErase2D,
    RandomFlip2D,
    RandomNoise2D,
    RandomRotate2D,
    RandomZoom2D,
)
from hdenseformer_tpu_torch.data.augment_device import augment_batch_3d
from hdenseformer_tpu_torch.data.augment3d import (
    RandomCrop3D,
    RandomFlip3D,
    RandomTranslationRotationZoom3D,
)
from hdenseformer_tpu_torch.data.io import hdf5_reader
from hdenseformer_tpu_torch.data.pipeline import BatchLoader, SegDataset
from hdenseformer_tpu_torch.data.transforms import (
    Compose,
    CropResize,
    MRNormalize,
    PETandCTNormalize,
    RawChannelsLast,
    ToOneHot,
    TruncAndNormalize,
)
from hdenseformer_tpu_torch.losses import get_loss
from hdenseformer_tpu_torch.metrics.batch import compute_dice
from hdenseformer_tpu_torch.metrics.running import (
    AverageMeter,
    RunningDice,
    confusion_matrix_device,
)
from hdenseformer_tpu_torch.models import SMP_2D, get_net
from hdenseformer_tpu_torch.models.layers import init_weights
from hdenseformer_tpu_torch.models.unet2d import load_torch_resnet_encoder
from hdenseformer_tpu_torch.train.checkpoint import (
    checkpoint_format,
    dfs_remove_weight,
    load_checkpoint,
    load_jax_state,
    metric_filename,
    save_checkpoint,
    wait_for_async_saves,
)
from hdenseformer_tpu_torch.train.logging import MetricsWriter
from hdenseformer_tpu_torch.train.state import (
    current_learning_rate,
    get_lr_scheduler,
    get_optimizer,
    set_learning_rate,
)
from hdenseformer_tpu_torch.utils import count_params, set_process_title


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _metrics(criterion, outs, batch, num_classes: int) -> Dict[str, torch.Tensor]:
    sw = batch.get("weight")
    loss = criterion(outs, batch["label"], sample_weight=sw)
    with torch.no_grad():
        logits = (outs[0] if isinstance(outs, (list, tuple)) else outs).detach().float()
        dice = compute_dice(logits, batch["label"], sample_weight=sw)
        cm = confusion_matrix_device(batch["label"].argmax(-1), logits.argmax(-1), num_classes,
                                     sample_weight=sw)
    return {"loss": loss, "dice": dice, "cm": cm}


def make_train_step(criterion: Callable, num_classes: int,
                    augment_fn: Optional[Callable] = None):
    """``train_step(state, batch, generator[, augment_generator]) -> (state,
    {"loss", "dice", "cm"})``.

    ``batch`` holds ``"image"`` (N, *spatial, C_in), the one-hot ``"label"``
    (N, *spatial, num_classes) and optionally ``"weight"`` (N,) of 1/0, all
    on the model's device. ``generator`` (on that device) feeds the model's
    dropout and advances with it; None where the model has none. Every model
    of ``get_net`` takes it. The state is updated in place and returned. A
    parameter that no loss reaches (the 2-D baselines' aux head) gets a zero
    gradient, as JAX's ``grad`` gives it, so the coupled L2 decay still
    moves it; torch's optimizers would skip it.

    With ``augment_fn(generator, image, int_label) -> (image, onehot_label)``
    the batch holds the raw image and the class volume instead, and the
    augmentation runs first on the device, without gradients and outside
    any checkpointed block, drawing from ``augment_generator`` (never the
    dropout generator).
    """

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator],
                   augment_generator: Optional[torch.Generator] = None):
        if augment_fn is not None:
            if augment_generator is None:
                raise ValueError("a train step with augment_fn needs an augment_generator")
            with torch.no_grad():
                image, label = augment_fn(augment_generator, batch["image"], batch["label"])
            batch = dict(batch, image=image, label=label)
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        outs = model(batch["image"], generator=generator)
        out = _metrics(criterion, outs, batch, num_classes)
        out["loss"].backward()
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:  # no loss reaches it (an aux head): JAX's gradient is 0,
                    p.grad = torch.zeros_like(p)  # and the coupled decay still moves it
        state.optimizer.step()
        state.step += 1
        out["loss"] = out["loss"].detach()
        return state, out

    return train_step


def make_eval_step(criterion: Callable, num_classes: int):
    """``eval_step(state, batch) -> {"loss", "dice", "cm"}``: no gradients,
    the model in eval mode (no dropout)."""

    def eval_step(state: TrainState, batch: Dict):
        model = state.model
        model.eval()
        with torch.no_grad():
            return _metrics(criterion, model(batch["image"]), batch, num_classes)

    return eval_step


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of optimizer step ``step`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


AUGMENT_STREAM = 777  # JAX folds 777 into the run's key for augmentation


def augment_seed(seed: int, step: int) -> int:
    """The on-device augmentation seed of optimizer step ``step``."""
    return int(np.random.SeedSequence([seed, AUGMENT_STREAM, step])
               .generate_state(1, np.uint64)[0])


def pad_and_mask_batch(batch: Dict[str, np.ndarray], batch_size: int, device
                       ) -> Dict[str, torch.Tensor]:
    """Pad a host batch to ``max(batch_size, its size)`` with cyclic repeats
    of its samples and a ``weight`` of 1 (real) / 0 (padding), then move it
    to ``device``; the masked loss, dice and confusion matrix equal those of
    the real samples alone, and every step of a run has one shape.

    On a CUDA device the arrays go through pinned memory without blocking,
    so the copy waits for nothing already queued on the card.
    """
    b = batch["image"].shape[0]
    pad_to = max(batch_size, b)
    w = np.zeros((pad_to,), np.float32)
    w[:b] = 1.0
    if b < pad_to:
        idx = np.arange(pad_to) % b
        batch = {k: np.asarray(v)[idx] for k, v in batch.items()}
    batch = dict(batch, weight=w)
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class EarlyStopping:
    """Request a stop after ``patience`` epochs without improvement.

    JAX's: a value at least ``best + delta`` (signed by ``op_type``) resets
    the counter; ``patience`` others in a row set ``early_stop``.
    """

    def __init__(self, patience=10, verbose=True, delta=0, monitor="val_loss", op_type="min"):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.monitor = monitor
        self.op_type = op_type
        self.sign = -1.0 if op_type == "min" else 1.0
        self.counter = 0
        self.best_score = None  # signed: higher is always better
        self.best_value = None  # the metric's value at the best epoch
        self.early_stop = False

    def __call__(self, value):
        value = float(value)
        score = self.sign * value
        improved = self.best_score is None or score >= self.best_score + self.delta
        if not improved:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            self.early_stop = self.counter >= self.patience
            return
        if self.verbose:
            prev = float("inf") * -self.sign if self.best_value is None else self.best_value
            print(f"{self.monitor} optimized ({prev:.6f} --> {value:.6f}). Saving model ...")
        self.best_score, self.best_value, self.counter = score, value, 0


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue 1 item {item}")


class SemanticSeg:
    """Training, evaluation and inference driver (the JAX class's knobs).

    ``reader(path, key)`` reads one volume of a case file, for training and
    inference alike (``hdf5_reader``); a subclass may read another format.
    """

    reader = staticmethod(hdf5_reader)

    def __init__(
        self,
        net_name=None,
        encoder_name=None,
        lr=1e-3,
        n_epoch=1,
        channels=1,
        num_classes=2,
        roi_number=1,
        scale=None,
        input_shape=None,
        crop=48,
        batch_size=6,
        num_workers=0,
        device=None,
        pre_trained=False,
        ex_pre_trained=False,
        ckpt_point=True,
        weight_path=None,
        weight_decay=0.0,
        momentum=0.95,
        gamma=0.1,
        milestones=(40, 80),
        T_max=5,
        topk=50,
        use_fp16=True,
        transform_3d=None,
        transform_2d=None,
        patch_size=(128, 256, 256),
        step_size=(64, 128, 128),
        transformer_depth=18,
        key_touple=("ct", "seg"),
        seed=0,
        use_pallas=None,
        device_augment=False,
        remat=True,
        s2d=None,
        norm_barrier=None,
        shift_pack=None,
    ):
        del norm_barrier, shift_pack  # XLA knobs: nothing in the port reads them
        self.net_name = net_name
        self.encoder_name = encoder_name
        self.lr = lr
        self.n_epoch = n_epoch
        self.channels = channels
        self.num_classes = num_classes
        self.roi_number = roi_number
        self.scale = scale
        self.input_shape = tuple(input_shape) if input_shape else None
        self.crop = crop
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.pre_trained = pre_trained
        self.ex_pre_trained = ex_pre_trained
        self.ckpt_point = ckpt_point
        self.weight_path = weight_path
        self.start_epoch = 0
        self.global_step = 0
        self.metrics_threshold = 0.0
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.gamma = gamma
        self.milestones = list(milestones)
        self.T_max = T_max
        self.topk = topk
        self.use_fp16 = use_fp16  # bf16 compute
        self.patch_size = tuple(patch_size)
        self.step_size = tuple(step_size)
        self.transformer_depth = transformer_depth
        self.key_touple = tuple(key_touple)
        self.seed = seed
        self.device_augment = device_augment

        if self.roi_number is not None and self.num_classes != 2:
            raise ValueError("num_classes must be set to 2 for binary segmentation")

        self.model = get_net(
            net_name,
            channels=channels,
            num_classes=num_classes,
            input_shape=self.input_shape,
            transformer_depth=transformer_depth,
            encoder_name=encoder_name,
            dtype=torch.bfloat16 if use_fp16 else None,
            use_kernels=use_pallas,
            remat=remat,
            s2d=s2d,
            device=device,
        )
        self.device = next(self.model.parameters()).device

        # the indexed transform tables, numbered as the reference's (the 3-D
        # table only exists for 3-D patch sizes)
        patch3d = self.patch_size if len(self.patch_size) == 3 else (1, 1, 1)
        self.transform_list_3d = [
            RandomCrop3D(patch3d),  # 1
            PETandCTNormalize(),  # 2
            CropResize(dim=self.input_shape, num_class=num_classes, crop=crop, channel=channels),  # 3
            RandomTranslationRotationZoom3D(mode="tr", num_class=num_classes),  # 4
            RandomFlip3D(mode="hv"),  # 5
            ToOneHot(num_class=num_classes, input_channel=channels),  # 6
            TruncAndNormalize(scale=self.scale),  # 7
            MRNormalize(),  # 8
        ]
        self.transform_list_2d = [
            MRNormalize(),  # 1
            CropResize(dim=self.input_shape, num_class=num_classes, crop=crop, channel=channels),  # 2
            RandomErase2D(scale_flag=False),  # 3
            RandomZoom2D(),  # 4
            RandomDistort2D(),  # 5
            RandomRotate2D(),  # 6
            RandomFlip2D(mode="hv"),  # 7
            RandomAdjust2D(),  # 8
            RandomNoise2D(),  # 9
            ToOneHot(num_class=num_classes, input_channel=channels),  # 10
            TruncAndNormalize(scale=self.scale),  # 11
        ]
        transform_3d = transform_3d or []
        transform_2d = transform_2d or []
        self.train_transform_3d = [self.transform_list_3d[i - 1] for i in transform_3d]
        self.val_transform_3d = [
            self.transform_list_3d[i - 1] for i in transform_3d if i in [1, 2, 3, 6]
        ]
        self.train_transform_2d = [self.transform_list_2d[i - 1] for i in transform_2d]
        self.val_transform_2d = [
            self.transform_list_2d[i - 1] for i in transform_2d if i in [1, 2, 10]
        ]

    # -- model state ------------------------------------------------------
    def build_state(self, optimizer: str = "Adam") -> TrainState:
        """Fresh weights from ``seed`` (the encoder's from ``ex_pre_trained``,
        where given) and a fresh optimizer."""
        init_weights(self.model, torch.Generator().manual_seed(self.seed))
        if self.ex_pre_trained:
            self._load_encoder_pretrained()
        opt = get_optimizer(optimizer, self.lr, weight_decay=self.weight_decay,
                            momentum=self.momentum, params=self.model.parameters())
        return TrainState(self.model, opt)

    def _load_encoder_pretrained(self) -> None:
        """``ex_pre_trained``: the reference's smp ``encoder_weights='imagenet'``
        from a local torchvision-format ResNet state dict (``.pth`` through
        ``torch.load``, or ``.npz``); ``True`` raises instead of training from
        scratch without saying so."""
        if self.net_name not in SMP_2D:
            raise ValueError("ex_pre_trained applies to the smp-style 2D baselines "
                             "(unet/unet++/deeplabv3+)")
        if not isinstance(self.ex_pre_trained, str):
            raise ValueError(
                "ex_pre_trained=True would download imagenet weights in the reference; this "
                "offline build needs a local checkpoint: pass "
                "ex_pre_trained='/path/to/resnet-imagenet.{pth,npz}'")
        path = self.ex_pre_trained
        if path.endswith(".npz"):
            with np.load(path) as f:
                state_dict = dict(f)
        else:
            state_dict = torch.load(path, map_location="cpu")
        load_torch_resnet_encoder(self.model, state_dict)

    def load_pretrained(self, state: TrainState, weight_path: str, ckpt_point=True
                        ) -> TrainState:
        """The checkpoint's weights; with ``ckpt_point`` also its optimizer
        state and step, and training resumes at the epoch after its own.

        The file is the port's (``torch.save``) or the JAX package's (flax
        msgpack), told apart by its bytes. A JAX checkpoint's Adam or SGD
        state is mapped onto the optimizer's (its learning rate is not: the
        trainer rebuilds the schedule on resume, as JAX's does)."""
        ckpt = load_checkpoint(weight_path)
        optimizer = state.optimizer if ckpt_point else None
        if checkpoint_format(weight_path) == "flax":
            has_optimizer = load_jax_state(ckpt, state.model, optimizer)
        else:
            state.model.load_state_dict(ckpt["model"])
            has_optimizer = ckpt.get("optimizer") is not None
            if optimizer is not None and has_optimizer:
                optimizer.load_state_dict(ckpt["optimizer"])
        if ckpt_point:
            self.start_epoch = int(ckpt["epoch"]) + 1
            if has_optimizer:
                state.step = int(ckpt["step"])
        return state

    # -- training ---------------------------------------------------------
    def trainer(
        self,
        train_path: Sequence[str],
        val_path: Sequence[str],
        cur_fold: int,
        output_dir=None,
        log_dir=None,
        optimizer="Adam",
        loss_fun="Cross_Entropy",
        class_weight=None,
        lr_scheduler=None,
        use_ds=False,
        n_devices: Optional[int] = None,
    ) -> Dict[str, Any]:
        if n_devices not in (None, 1):
            raise _not_ported(f"training on {n_devices} devices", 6)
        is_3d = len(self.input_shape) > 2
        if self.device_augment and not is_3d:
            raise ValueError("device_augment currently supports the 3D pipeline")
        output_dir = os.path.join(output_dir, f"fold{cur_fold}")
        log_dir = os.path.join(log_dir, f"fold{cur_fold}")
        for d in (log_dir, output_dir):
            if os.path.exists(d) and not self.pre_trained:
                shutil.rmtree(d)
            os.makedirs(d, exist_ok=True)

        writer = MetricsWriter(log_dir)
        criterion = get_loss(loss_fun, class_weight=class_weight, topk=self.topk, use_ds=use_ds)
        state = self.build_state(optimizer)
        if self.pre_trained and self.weight_path:
            state = self.load_pretrained(state, self.weight_path, self.ckpt_point)
        print(f"{self.net_name}: {count_params(state.model) / 1e6:.3f} M params")

        augment_fn, augment_generator = None, None
        train_tfm = Compose(self.train_transform_3d if is_3d else self.train_transform_2d)
        if self.device_augment:
            patch, ncls = self.patch_size, self.num_classes

            def augment_fn(generator, image, label):
                return augment_batch_3d(generator, image, label, patch, num_classes=ncls)

            augment_generator = torch.Generator(device=self.device)
            train_tfm = Compose([RawChannelsLast()])
        train_step = make_train_step(criterion, self.num_classes, augment_fn=augment_fn)
        eval_step = make_eval_step(criterion, self.num_classes)
        generator = torch.Generator(device=self.device)

        train_ds = SegDataset(
            train_path, roi_number=self.roi_number, num_class=self.num_classes,
            transform=train_tfm, img_key=self.key_touple[0],
            lab_key=self.key_touple[1], reader=self.reader,
        )
        val_ds = SegDataset(
            val_path, roi_number=self.roi_number, num_class=self.num_classes,
            transform=Compose(self.val_transform_3d if is_3d else self.val_transform_2d),
            img_key=self.key_touple[0],
            lab_key=self.key_touple[1], reader=self.reader,
        )
        train_loader = BatchLoader(train_ds, self.batch_size, shuffle=True,
                                   num_workers=self.num_workers, seed=self.seed)
        val_loader = BatchLoader(val_ds, self.batch_size, shuffle=False,
                                 num_workers=self.num_workers, seed=self.seed)
        self.global_step = self.start_epoch * math.ceil(len(train_path) / self.batch_size)

        sched = get_lr_scheduler(
            lr_scheduler, self.lr, n_epoch=self.n_epoch,
            milestones=self.milestones, gamma=self.gamma, T_max=self.T_max,
        )
        early_stopping = EarlyStopping(patience=30, verbose=True, monitor="val_dice",
                                       op_type="max")
        history = {"train_loss": [], "val_loss": [], "train_dice": [], "val_dice": [],
                   "train_run_dice": [], "val_run_dice": []}
        prev_val_loss = None

        for epoch in range(self.start_epoch, self.n_epoch):
            set_process_title(f"{self.net_name}: {epoch}/{self.n_epoch}")
            if sched is not None:
                set_learning_rate(state.optimizer, sched.step(prev_val_loss))

            state, tr = self._run_epoch(state, train_loader, train_step, epoch,
                                        (generator, augment_generator), train=True)
            _, va = self._run_epoch(state, val_loader, eval_step, epoch, None, train=False)
            prev_val_loss = va["loss"]

            print(f"epoch:{epoch}/{self.n_epoch},train_loss:{tr['loss']:.5f},"
                  f"val_loss:{va['loss']:.5f}")
            print(f"epoch:{epoch}/{self.n_epoch},train_dice:{tr['dice']:.5f},"
                  f"train_run_dice:{tr['run_dice']:.5f},val_dice:{va['dice']:.5f},"
                  f"val_run_dice:{va['run_dice']:.5f}")
            print(f"epoch:{epoch}/{self.n_epoch},train_seconds:{tr['seconds']:.3f} "
                  f"({tr['steps']} steps, {tr['loader_wait_seconds']:.3f} s waiting on the "
                  f"loader),val_seconds:{va['seconds']:.3f}")
            writer.add_scalars("data/loss", {"train": tr["loss"], "val": va["loss"]}, epoch)
            writer.add_scalars("data/dice", {"train": tr["dice"], "val": va["dice"]}, epoch)
            writer.add_scalars("data/run_dice", {"train": tr["run_dice"],
                                                 "val": va["run_dice"]}, epoch)
            writer.add_scalar("data/lr", current_learning_rate(state.optimizer), epoch)
            writer.add_scalars("time/train", {k: tr[k] for k in (
                "seconds", "steps", "loader_wait_seconds")}, epoch)
            writer.add_scalars("time/val", {k: va[k] for k in (
                "seconds", "steps", "loader_wait_seconds")}, epoch)
            for k in history:
                src, key = (tr, k[6:]) if k.startswith("train_") else (va, k[4:])
                history[k].append(src[key])

            early_stopping(va["dice"])
            if va["dice"] > self.metrics_threshold:
                self.metrics_threshold = va["dice"]
                fname = metric_filename(epoch, tr["loss"], tr["dice"], tr["run_dice"],
                                        va["loss"], va["dice"], va["run_dice"])
                print(f"Save as: {fname}")
                save_checkpoint(os.path.join(output_dir, fname), state.model.state_dict(),
                                state.optimizer.state_dict(), epoch, state.step,
                                async_save=True)
            if early_stopping.early_stop:
                print("Early stopping")
                break

        writer.close()
        wait_for_async_saves()
        dfs_remove_weight(output_dir, retain=3)
        self.state = state
        return history

    def _run_epoch(self, state, loader, step_fn, epoch, generators, train: bool):
        """One pass over ``loader``: the loss, dice and running dice, and the
        wall seconds, steps and seconds spent waiting for the loader.
        ``generators`` is (dropout, augmentation or None) in training."""
        loss_meter, dice_meter = AverageMeter(), AverageMeter()
        run_dice = RunningDice(labels=range(self.num_classes), ignore_label=-1)
        # metrics stay on the card until drained (every 10 global steps, the
        # reference's print cadence, and at epoch end): the loop never waits
        # for the card in between
        pending: List = []

        def drain():
            if not pending:
                return
            scalars = torch.stack([torch.stack([m["loss"].float(), m["dice"].float()])
                                   for _, m in pending]).cpu().tolist()
            cms = torch.stack([m["cm"] for _, m in pending]).cpu().numpy()
            for (n, _), (loss, dice), cm in zip(pending, scalars, cms):
                loss_meter.update(loss, n)
                dice_meter.update(dice, n)
                run_dice.update_from_matrix(cm)
            pending.clear()

        t0 = time.perf_counter()
        wait, steps = 0.0, 0
        batches = iter(loader.epoch(epoch))
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t_wait
            if batch is None:
                break
            n = batch["image"].shape[0]
            batch = pad_and_mask_batch(batch, self.batch_size, self.device)
            if train:
                generator, augment_generator = generators
                generator.manual_seed(step_seed(self.seed, state.step))
                if augment_generator is not None:
                    augment_generator.manual_seed(augment_seed(self.seed, state.step))
                state, metrics = step_fn(state, batch, generator, augment_generator)
            else:
                metrics = step_fn(state, batch)
            pending.append((n, metrics))
            if train:
                if self.global_step % 10 == 0:
                    drain()
                    rd, dice_list = run_dice.compute_dice()
                    print("Category Dice: ", dice_list)
                    print(f"epoch:{epoch}/{self.n_epoch},step:{steps},"
                          f"train_loss:{loss_meter.val:.5f},train_dice:{dice_meter.val:.5f},"
                          f"run_dice:{rd:.5f},lr:{current_learning_rate(state.optimizer)}")
                self.global_step += 1
            steps += 1
        drain()
        return state, {"loss": loss_meter.avg, "dice": dice_meter.avg,
                       "run_dice": run_dice.compute_dice()[0],
                       "seconds": time.perf_counter() - t0, "steps": steps,
                       "loader_wait_seconds": wait}

    # -- inference --------------------------------------------------------
    def inference_slidingwindow(
        self,
        test_path,
        save_path,
        state=None,
        window_batch: int = 8,
        use_gaussian: bool = False,
        mesh=None,
        save_nii: bool = False,
    ):
        """Sliding-window inference of every case of ``test_path`` (a
        directory's ``*.hdf5`` cases, or a list of case paths) with the
        trained state, else ``weight_path``'s weights."""
        from hdenseformer_tpu_torch.infer.sliding import inference_slidingwindow

        if state is None:
            state = getattr(self, "state", None)
        if state is None:
            if not self.weight_path:
                raise ValueError("no parameters available for inference")
            state = self.load_pretrained(self.build_state(), self.weight_path, ckpt_point=False)
        state.model.eval()
        return inference_slidingwindow(
            state.model, test_path, save_path,
            num_classes=self.num_classes,
            patch_size=self.patch_size, step_size=self.step_size,
            img_key=self.key_touple[0],
            window_batch=window_batch, use_gaussian=use_gaussian,
            mesh=mesh, save_nii=save_nii, reader=self.reader,
        )
