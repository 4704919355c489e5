"""Command line of the port: train / train-cross / inf-sw / predict-2d / eval / convert.

Counterpart of ``hdenseformer_tpu/cli.py``, with its flags and one more,
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels on the host). There is no silent fallback: train and inf-sw raise
without a card unless ``--device cpu`` is given.

Usage:
    python -m hdenseformer_tpu_torch.cli -m train-cross --dataset Hecktor21 \
        --net HDenseFormer_32 --data-path ./dataset/hecktor

``--net`` takes every name of ``models.get_net``: HDenseFormer_32/_16,
hecktor20top1, unet_3d, da_unet, se_unet, da_se_unet, res_da_se_unet,
TransBTS and unetr in 3-D; HDenseFormer_2D_32/_16 and unet, unet++ and
deeplabv3+ (with ``--encoder resnet18|resnet34|resnet50``) in 2-D. A 2-D net
trains on 2-D slice cases (the PI-CAI22 preset) and ``-m predict-2d`` runs
it slice by slice over the volumes of ``--test-path`` (``infer/slices.py``).

``--profile DIR`` writes a ``torch.profiler`` trace of each fold's
``trainer()`` call under DIR (``utils.profiling.profiler_trace``; JAX's help
text says the first epoch, but its code traces the whole call, as here).
``--n-devices N`` above 1 runs train and inf-sw data-parallel over N
processes of ``torch.distributed``, one a card, launched by
``torchrun --nproc-per-node N -m hdenseformer_tpu_torch.cli ... --n-devices
N`` or under the JAX package's env contract (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``; ``parallel/mesh.py``): each
process takes ``cuda:LOCAL_RANK`` (``--device cpu``: gloo on the host) and
only rank 0 writes.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="hdenseformer_tpu_torch")
    p.add_argument(
        "-m", "--mode", default="train-cross",
        choices=["train", "train-cross", "inf-sw", "predict-2d", "eval", "convert"],
    )
    p.add_argument("--dataset", default="Hecktor21")
    p.add_argument("--net", dest="net_name", default=None)
    p.add_argument("--encoder", dest="encoder_name", default=None)
    p.add_argument("--data-path", default=None)
    p.add_argument("--test-path", default=None)
    p.add_argument("--save-path", default=None)
    p.add_argument("--version", default="v1.0")
    p.add_argument("--fold", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--input-shape", type=int, nargs="+", default=None,
                   help="override the preset input/patch shape, e.g. 144 144 144")
    p.add_argument("--step-size", type=int, nargs="+", default=None,
                   help="sliding-window step, e.g. 72 72 72")
    p.add_argument("--transformer-depth", type=int, default=None)
    p.add_argument("--folds", type=int, default=None, help="number of CV folds")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of each fold's training into DIR")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default cuda; cpu for the plain versions)")
    # inf-sw mode
    p.add_argument("--window-batch", type=int, default=8,
                   help="sliding-window inference: windows per model call")
    p.add_argument("--use-gaussian", action="store_true",
                   help="gaussian importance weighting of window overlaps")
    p.add_argument("--save-nii", action="store_true",
                   help="also save predictions as .nii.gz volumes")
    # convert mode
    p.add_argument("--convert-format", choices=["hecktor", "brats"], default="hecktor")
    p.add_argument("--input-dir", default=None)
    p.add_argument("--output-dir", default=None)
    return p


def make_config(args):
    from hdenseformer_tpu_torch.configs import get_config

    overrides = {"version": args.version}
    if args.net_name:
        overrides["net_name"] = args.net_name
        overrides["mode"] = "2d_seg" if "2D" in args.net_name or args.net_name in (
            "unet", "unet++", "deeplabv3+") else "3d_seg"
    if args.encoder_name:
        overrides["encoder_name"] = args.encoder_name
    if args.data_path:
        overrides["data_path"] = args.data_path
    if args.test_path:
        overrides["test_path"] = args.test_path
    if args.epochs:
        overrides["n_epoch"] = args.epochs
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.lr:
        overrides["lr"] = args.lr
    if args.fold:
        overrides["current_fold"] = args.fold
    if args.n_devices:
        overrides["n_devices"] = args.n_devices
    if args.no_bf16:
        overrides["use_fp16"] = False
    if args.input_shape:
        overrides["input_shape"] = tuple(args.input_shape)
        if len(args.input_shape) == 3:
            overrides["patch_size"] = tuple(args.input_shape)
    if args.step_size:
        overrides["step_size"] = tuple(args.step_size)
    if args.transformer_depth:
        overrides["transformer_depth"] = args.transformer_depth
    if args.folds:
        overrides["fold_num"] = args.folds
    if args.seed is not None:
        overrides["seed"] = args.seed
    return get_config(args.dataset, **overrides)


def _report_params_flops(seg, cfg) -> None:
    """Parameter count and forward GFLOPs at startup (FlopCounterMode on one
    zero input where JAX reads XLA's cost analysis)."""
    import torch

    from hdenseformer_tpu_torch.utils import count_flops, count_params

    print(f"params: {count_params(seg.model) / 1e6:.3f} M")
    seg.model.eval()
    x = torch.zeros((1,) + tuple(cfg.input_shape) + (cfg.channels,), device=seg.device)
    flops = count_flops(seg.model, x)
    if flops:
        print(f"forward GFLOPs: {flops / 1e9:.3f}")
    else:
        print("(flop report skipped: the counter could not trace the forward)")


def run_train(cfg, folds, device, profile_dir=None) -> list:
    """Train each fold of ``folds`` (under ``profile_dir``'s profiler trace
    where given); returns each fold's history."""
    from hdenseformer_tpu_torch.data.pipeline import get_cross_validation_by_sample
    from hdenseformer_tpu_torch.parallel.mesh import local_device, maybe_distributed_init
    from hdenseformer_tpu_torch.train.loop import SemanticSeg
    from hdenseformer_tpu_torch.utils import profiler_trace

    if maybe_distributed_init(device):
        device = local_device(device)
    path_list = cfg.path_list
    if not path_list:
        raise FileNotFoundError(f"no .hdf5 cases under {cfg.data_path}")
    reported = False
    histories = []
    for current_fold in folds:
        print(f"=== Training Fold {current_fold} ===")
        seg = SemanticSeg(**cfg.init_trainer_kwargs(), device=device)
        if not reported:
            _report_params_flops(seg, cfg)
            reported = True
        train_path, val_path = get_cross_validation_by_sample(
            path_list, cfg.fold_num, current_fold, shuffle_seed=cfg.seed
        )
        print("Train set length", len(train_path), "Val set length", len(val_path))
        t0 = time.time()
        with profiler_trace(profile_dir) as trace:
            histories.append(seg.trainer(
                train_path=train_path,
                val_path=val_path,
                cur_fold=current_fold,
                **cfg.setup_trainer_kwargs(),
            ))
        if trace:
            print(f"profiler trace: {trace}")
        print(f"run time:{time.time() - t0:.4f}")
    return histories


def run_inference(cfg, args) -> list:
    """Sliding-window inference with each fold's newest checkpoint; returns
    the paths written."""
    from hdenseformer_tpu_torch.parallel.mesh import make_mesh, maybe_distributed_init
    from hdenseformer_tpu_torch.train.checkpoint import get_weight_path
    from hdenseformer_tpu_torch.train.loop import SemanticSeg

    mesh, device = None, args.device
    if cfg.n_devices and cfg.n_devices > 1:
        maybe_distributed_init(device)
        mesh = make_mesh(cfg.n_devices, device)
        device = mesh.device
    test_path = args.test_path or cfg.test_path
    written = []
    for current_fold in range(1, cfg.fold_num + 1):
        print(f"=== Predicting Fold {current_fold} ===")
        ckpt_dir = os.path.join(cfg.output_dir, f"fold{current_fold}")
        weight_path = get_weight_path(ckpt_dir)
        print(weight_path)
        if weight_path is None:
            continue
        kwargs = cfg.init_trainer_kwargs()
        kwargs["weight_path"] = weight_path
        kwargs["pre_trained"] = True
        seg = SemanticSeg(**kwargs, device=device)
        save_path = args.save_path or os.path.join(
            cfg.save_root, "3d", cfg.version, f"fold{current_fold}"
        )
        t0 = time.time()
        written += seg.inference_slidingwindow(
            test_path, save_path,
            window_batch=args.window_batch, use_gaussian=args.use_gaussian,
            mesh=mesh, save_nii=args.save_nii,
        )
        print(f"run time:{time.time() - t0:.4f}")
    return written


def run_predict_2d(cfg, args) -> list:
    """Per-slice 2-D prediction of every case of the test path with the
    newest checkpoint of ``--fold``; returns the paths written."""
    from hdenseformer_tpu_torch.infer.slices import eval_dir_2d
    from hdenseformer_tpu_torch.train.checkpoint import get_weight_path
    from hdenseformer_tpu_torch.train.loop import SemanticSeg

    ckpt_dir = os.path.join(cfg.output_dir, f"fold{cfg.current_fold}")
    weight_path = get_weight_path(ckpt_dir)
    if weight_path is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    kwargs = cfg.init_trainer_kwargs()
    kwargs["weight_path"] = weight_path
    kwargs["pre_trained"] = True
    seg = SemanticSeg(**kwargs, device=args.device)
    state = seg.load_pretrained(seg.build_state(), weight_path, ckpt_point=False)
    save_path = args.save_path or os.path.join(
        cfg.save_root, "2d", cfg.version, f"fold{cfg.current_fold}"
    )
    written = eval_dir_2d(
        state.model, args.test_path or cfg.test_path, save_path,
        input_shape=cfg.input_shape, num_classes=cfg.num_classes,
        channels=cfg.channels, img_key=cfg.keys[0], capture=seg.capture,
    )
    print(f"wrote {len(written)} prediction volumes to {save_path}")
    return written


def run_eval(cfg, args) -> list:
    """Offline eval: predicted .npy against the ground truth -> per-case metrics
    in ``<save-path>/eval_results.json``; returns the rows."""
    from hdenseformer_tpu_torch.data.io import hdf5_reader
    from hdenseformer_tpu_torch.metrics.eval3d import (
        multi_asd,
        multi_dice,
        multi_hd,
        multi_jc,
        multi_vs,
    )

    pred_dir = args.save_path
    gt_dir = args.test_path or cfg.test_path
    rows = []
    for pred_path in sorted(glob.glob(os.path.join(pred_dir, "*.npy"))):
        case = os.path.basename(pred_path)[:-4]
        gt_path = os.path.join(gt_dir, case + ".hdf5")
        if not os.path.exists(gt_path):
            continue
        pred = np.load(pred_path)
        gt = hdf5_reader(gt_path, cfg.keys[1])
        n_fg = cfg.num_classes - 1
        dice_list, mean_dice = multi_dice(gt, pred, n_fg)
        hd_list, mean_hd = multi_hd(gt, pred, n_fg)
        _, mean_jc = multi_jc(gt, pred, n_fg)
        _, mean_vs = multi_vs(gt, pred, n_fg)
        _, mean_asd = multi_asd(gt, pred, n_fg)
        rows.append(
            dict(case=case, dice=mean_dice, hd95=mean_hd, jaccard=mean_jc,
                 vs=mean_vs, asd=mean_asd, dice_list=dice_list, hd_list=hd_list)
        )
        print(f"{case}: dice={mean_dice} hd95={mean_hd}")
    out_json = os.path.join(pred_dir, "eval_results.json")
    with open(out_json, "w") as f:
        json.dump(rows, f, indent=2)
    if rows:
        print("mean dice:", np.nanmean([r["dice"] for r in rows]))
        print("mean hd95:", np.nanmean([r["hd95"] for r in rows]))
    print("wrote", out_json)
    return rows


def run_convert(args) -> list:
    from hdenseformer_tpu_torch.data.convert import nii2npy_brats, nii2npy_hecktor

    if args.convert_format == "hecktor":
        return nii2npy_hecktor(args.input_dir, args.output_dir)
    return nii2npy_brats(args.input_dir, args.output_dir)


def main(argv=None):
    """Run one mode; returns what it made (histories, paths or eval rows)."""
    args = build_parser().parse_args(argv)
    if args.mode == "convert":
        return run_convert(args)
    cfg = make_config(args)
    if args.mode in ("train", "train-cross", "inf-sw", "predict-2d"):
        import torch

        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless --device cpu is given")
    if args.mode == "train-cross":
        return run_train(cfg, range(1, cfg.fold_num + 1), args.device, args.profile)
    if args.mode == "train":
        return run_train(cfg, [cfg.current_fold], args.device, args.profile)
    if args.mode == "inf-sw":
        return run_inference(cfg, args)
    if args.mode == "predict-2d":
        return run_predict_2d(cfg, args)
    return run_eval(cfg, args)


if __name__ == "__main__":
    main()
