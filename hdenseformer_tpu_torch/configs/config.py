"""Typed experiment configuration with per-dataset presets.

A copy of ``hdenseformer_tpu/configs/config.py`` (the port imports nothing
of the JAX package) with the same fields, presets and coupling rules, so
that a JAX config maps one to one:

- the loss is chosen by class count: FocalLoss if binary, else CEPlusDice;
- deep supervision iff 'DenseFormer' is in the net's name;
- the batch size by mode: 2 in 3-D, 24 in 2-D;
- per-dataset channel, ROI, shape and key tables.

``use_pallas`` is ``get_net``'s ``use_kernels`` in the port (None: the
CUDA kernels on a CUDA device). ``norm_barrier`` and ``shift_pack`` are
knobs of the XLA build, kept so that JAX configs map one to one, and
ignored by the port.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

DATASET_PRESETS = {
    "Hecktor21": dict(
        channels=2, roi_number=None, input_shape=(144, 144, 144),
        keys=("ct", "seg"), mode="3d_seg", scale=None,
    ),
    "BraTS21": dict(
        channels=4, roi_number=None, input_shape=(128, 128, 128),
        keys=("image", "label"), mode="3d_seg", scale=None, num_classes=4,
    ),
    "PI-CAI22": dict(
        channels=3, roi_number=None, input_shape=(384, 384),
        keys=("ct", "seg"), mode="2d_seg", scale=None,
    ),
    "LITS": dict(
        channels=1, roi_number=2, input_shape=(448, 512, 512),
        keys=("image", "label"), mode="3d_seg", scale=(-100, 200),
    ),
    "KITS": dict(
        channels=1, roi_number=2, input_shape=(256, 512, 512),
        keys=("image", "label"), mode="3d_seg", scale=(-100, 200),
    ),
}


@dataclass
class ExperimentConfig:
    # identity
    dataset: str = "Hecktor21"
    mode: str = "3d_seg"
    net_name: str = "HDenseFormer_32"
    encoder_name: Optional[str] = None
    version: str = "v1.0"

    # data
    data_path: str = "./dataset/Hecktor21/train_3d_seg"
    channels: int = 2
    num_classes: int = 2
    roi_number: Optional[int] = None
    input_shape: Tuple[int, ...] = (144, 144, 144)
    keys: Tuple[str, str] = ("ct", "seg")
    scale: Optional[Tuple[float, float]] = None
    crop: int = 0

    # cross-validation
    fold_num: int = 5
    current_fold: int = 1

    # training
    lr: float = 1e-3
    n_epoch: int = 100
    batch_size: Optional[int] = None  # None -> 2 for 3d / 24 for 2d
    num_workers: int = 4
    optimizer: str = "Adam"
    loss_fun: Optional[str] = None  # None -> by class count
    class_weight: Optional[Sequence[float]] = None
    lr_scheduler: str = "poly_lr"
    weight_decay: float = 1e-4
    momentum: float = 0.9
    gamma: float = 0.1
    milestones: Tuple[int, ...] = (50, 80)
    T_max: int = 5
    topk: int = 10
    use_fp16: bool = True  # bf16 compute
    use_ds: Optional[bool] = None  # None -> by net name
    use_pallas: Optional[bool] = None  # the port's use_kernels; None: kernels on the GPU
    remat: bool = True  # rematerialize model blocks (torch.utils.checkpoint)
    s2d: Optional[bool] = None  # None: space-to-depth packing where JAX's rule packs
    norm_barrier: Optional[str] = None  # XLA knob, ignored by the port
    shift_pack: Optional[str] = None  # XLA knob, ignored by the port
    seed: int = 0

    # augmentation selections (the reference's numbering)
    transform_3d: Tuple[int, ...] = (1, 2, 4, 5, 6)
    transform_2d: Tuple[int, ...] = (1, 6, 7, 10)

    # model/infer
    patch_size: Tuple[int, ...] = (144, 144, 144)
    step_size: Tuple[int, ...] = (72, 72, 72)
    transformer_depth: int = 24

    # resume
    pre_trained: bool = False
    ex_pre_trained: bool = False
    ckpt_point: bool = False
    weight_path: Optional[str] = None

    # io
    ckpt_root: str = "./ckpt"
    log_root: str = "./log"
    test_path: Optional[str] = None
    save_root: str = "./segout"

    # devices
    n_devices: Optional[int] = None

    def __post_init__(self):
        if self.batch_size is None:
            self.batch_size = 2 if "3d" in self.mode else 24
        if self.loss_fun is None:
            self.loss_fun = "FocalLoss" if self.num_classes == 2 else "CEPlusDice"
        if self.use_ds is None:
            self.use_ds = "DenseFormer" in self.net_name

    @property
    def path_list(self):
        return sorted(glob.glob(os.path.join(self.data_path, "*.hdf5")))

    @property
    def output_dir(self) -> str:
        return os.path.join(self.ckpt_root, self.dataset, self.mode, self.version)

    @property
    def log_dir(self) -> str:
        return os.path.join(self.log_root, self.dataset, self.mode, self.version)

    def init_trainer_kwargs(self) -> dict:
        """Keyword arguments of ``SemanticSeg(...)``."""
        return dict(
            net_name=self.net_name,
            encoder_name=self.encoder_name,
            lr=self.lr,
            n_epoch=self.n_epoch,
            channels=self.channels,
            num_classes=self.num_classes,
            roi_number=self.roi_number,
            scale=self.scale,
            input_shape=self.input_shape,
            crop=self.crop,
            batch_size=self.batch_size,
            num_workers=self.num_workers,
            pre_trained=self.pre_trained,
            ex_pre_trained=self.ex_pre_trained,
            ckpt_point=self.ckpt_point,
            weight_path=self.weight_path,
            weight_decay=self.weight_decay,
            momentum=self.momentum,
            gamma=self.gamma,
            milestones=self.milestones,
            T_max=self.T_max,
            topk=self.topk,
            use_fp16=self.use_fp16,
            transform_3d=list(self.transform_3d),
            transform_2d=list(self.transform_2d),
            patch_size=self.patch_size,
            step_size=self.step_size,
            transformer_depth=self.transformer_depth,
            key_touple=self.keys,
            seed=self.seed,
            use_pallas=self.use_pallas,
            remat=self.remat,
            s2d=self.s2d,
            norm_barrier=self.norm_barrier,
            shift_pack=self.shift_pack,
        )

    def setup_trainer_kwargs(self) -> dict:
        """Keyword arguments of ``SemanticSeg.trainer(...)``."""
        return dict(
            output_dir=self.output_dir,
            log_dir=self.log_dir,
            optimizer=self.optimizer,
            loss_fun=self.loss_fun,
            class_weight=self.class_weight,
            lr_scheduler=self.lr_scheduler,
            use_ds=self.use_ds,
            n_devices=self.n_devices,
        )


def get_config(dataset: str = "Hecktor21", **overrides) -> ExperimentConfig:
    """A config from a dataset preset plus overrides."""
    if dataset not in DATASET_PRESETS:
        raise ValueError(f"unknown dataset {dataset!r}; options: {sorted(DATASET_PRESETS)}")
    preset = dict(DATASET_PRESETS[dataset])
    preset["dataset"] = dataset
    preset.update(overrides)
    valid = {f.name for f in dataclasses.fields(ExperimentConfig)}
    unknown = set(preset) - valid
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return ExperimentConfig(**preset)
