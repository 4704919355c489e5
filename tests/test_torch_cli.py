"""The port's command line end to end on the CPU (``--device cpu``).

convert (as ``python -m hdenseformer_tpu_torch.cli``) -> train -> inf-sw ->
eval on 4 synthetic NIfTI cases of 40^3: HDenseFormer_16 at a 32^3 patch,
depth 2, fp32 (HDenseFormer_32 differs only in width). The predictions
are those of ``predict_volume`` under the checkpoint's weights, and the
eval rows those of the JAX package's eval3d on the same files.
train-cross runs both folds of a 2-fold split.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

from hdenseformer_tpu.metrics import eval3d as jeval  # noqa: E402
from hdenseformer_tpu_torch import cli  # noqa: E402
from hdenseformer_tpu_torch.data.io import hdf5_reader, write_nifti  # noqa: E402
from hdenseformer_tpu_torch.data.transforms import PETandCTNormalize  # noqa: E402
from hdenseformer_tpu_torch.infer.sliding import predict_volume  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATIENTS = ("pa", "pb", "pc", "pd")
SIZE = 40
COMMON = ["--dataset", "Hecktor21", "--input-shape", "32", "32", "32", "--step-size", "16",
          "16", "16", "--transformer-depth", "2", "--no-bf16", "--folds", "2", "--device",
          "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's cores,
    and torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def h5_cases(tmp_path_factory):
    """4 patients' CT, PET and tumour NIfTI files (noise around a sphere),
    converted by the port's CLI run as a module."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    grid = np.indices((SIZE,) * 3) - SIZE / 2
    for i, pid in enumerate(PATIENTS):
        ball = (np.sqrt((grid ** 2).sum(0)) < 6 + i).astype(np.float32)
        d = root / "raw" / pid
        d.mkdir(parents=True)
        write_nifti(str(d / f"{pid}_ct.nii.gz"),
                    (rng.normal(0, 200, ball.shape) + 300 * ball).astype(np.int16))
        write_nifti(str(d / f"{pid}_pt.nii.gz"),
                    (rng.gamma(2, 100, ball.shape) + 800 * ball).astype(np.int16))
        write_nifti(str(d / f"{pid}_gtvt.nii.gz"), ball.astype(np.uint8))
    proc = subprocess.run(
        [sys.executable, "-m", "hdenseformer_tpu_torch.cli", "-m", "convert", "--input-dir",
         str(root / "raw"), "--output-dir", str(root / "h5")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(root / "h5")) == [f"{p}.hdf5" for p in PATIENTS]
    return root


def test_train_inf_sw_eval(h5_cases, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # ./ckpt, ./log as the JAX CLI lays them out
    h5 = str(h5_cases / "h5")
    hist = cli.main(["-m", "train", "--net", "HDenseFormer_16", "--data-path", h5,
                     "--epochs", "2", "--fold", "1", "--version", "vt"] + COMMON)
    assert len(hist) == 1 and len(hist[0]["train_loss"]) == 2
    ckpt_dir = tmp_path / "ckpt" / "Hecktor21" / "3d_seg" / "vt" / "fold1"
    kept = sorted(os.listdir(ckpt_dir))
    assert 1 <= len(kept) <= 3 and all(
        k.startswith("epoch=") and "-val_dice=" in k and k.endswith(".ckpt") for k in kept)
    with open(tmp_path / "log" / "Hecktor21" / "3d_seg" / "vt" / "fold1" / "metrics.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"data/loss/train", "data/dice/val", "data/lr", "time/train/seconds"} <= tags

    seg_dir = tmp_path / "seg"
    written = cli.main(["-m", "inf-sw", "--net", "HDenseFormer_16", "--test-path", h5,
                        "--save-path", str(seg_dir), "--version", "vt"] + COMMON)
    assert [os.path.basename(p) for p in written] == [f"{p}.npy" for p in PATIENTS]
    newest = max(kept, key=lambda k: int(k.split("-")[0].split("=")[1]))
    net = get_net("HDenseFormer_16", 2, 2, (32, 32, 32), transformer_depth=2, device="cpu")
    net.load_state_dict(load_checkpoint(str(ckpt_dir / newest))["model"])
    for pid in PATIENTS:
        image = PETandCTNormalize()({"image": hdf5_reader(f"{h5}/{pid}.hdf5", "ct")})["image"]
        want = predict_volume(net, image, (32, 32, 32), (16, 16, 16), 2, window_batch=8)
        np.testing.assert_array_equal(np.load(seg_dir / f"{pid}.npy"), want)

    rows = cli.main(["-m", "eval", "--test-path", h5, "--save-path", str(seg_dir)])
    with open(seg_dir / "eval_results.json") as f:
        saved = json.load(f)
    want = []
    for pid in PATIENTS:
        gt, pred = hdf5_reader(f"{h5}/{pid}.hdf5", "seg"), np.load(seg_dir / f"{pid}.npy")
        dice_list, dice = jeval.multi_dice(gt, pred, 1)
        hd_list, hd = jeval.multi_hd(gt, pred, 1)
        want.append(dict(case=pid, dice=dice, hd95=hd, jaccard=jeval.multi_jc(gt, pred, 1)[1],
                         vs=jeval.multi_vs(gt, pred, 1)[1], asd=jeval.multi_asd(gt, pred, 1)[1],
                         dice_list=dice_list, hd_list=hd_list))
    np.testing.assert_equal(saved, want)
    np.testing.assert_equal(rows, want)


def test_train_cross_runs_every_fold(h5_cases, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    hist = cli.main(["-m", "train-cross", "--net", "HDenseFormer_16", "--data-path",
                     str(h5_cases / "h5"), "--epochs", "1", "--version", "vc"] + COMMON)
    assert len(hist) == 2
    for fold in ("fold1", "fold2"):
        assert os.listdir(tmp_path / "ckpt" / "Hecktor21" / "3d_seg" / "vc" / fold)


@pytest.mark.parametrize("mode", ["train", "train-cross", "inf-sw"])
def test_no_card_raises_without_device_cpu(h5_cases, mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-m", mode, "--data-path", str(h5_cases / "h5"), "--test-path",
                  str(h5_cases / "h5")])


@pytest.mark.parametrize("argv,item", [
    (["-m", "inf-sw", "--n-devices", "2"], "item 6"),
    (["-m", "train", "--profile", "trace"], "item 6"),
])
def test_unported_modes_raise(argv, item):
    """The modes that ROADMAP.md queue 1 ``item`` left unported run now: in
    one CPU process with no distributed world and no data they stop at what
    is missing (the two processes of ``--n-devices 2``, the cases of the
    default data path), not at a ``NotImplementedError``."""
    error, match = {"inf-sw": (ValueError, "needs 2 processes"),
                    "train": (FileNotFoundError, "no .hdf5 cases")}[argv[1]]
    with pytest.raises(error, match=match):
        cli.main(argv + ["--device", "cpu"])


def test_config_matches_jax_presets_and_overrides():
    from hdenseformer_tpu.cli import build_parser as jparser, make_config as jconfig

    argv = ["-m", "train", "--net", "HDenseFormer_32", "--epochs", "7", "--batch-size", "3",
            "--input-shape", "64", "64", "64", "--folds", "3", "--seed", "11", "--no-bf16"]
    ours = cli.make_config(cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    ref = jconfig(jparser().parse_args(argv))
    assert ours.init_trainer_kwargs() == ref.init_trainer_kwargs()
    assert ours.setup_trainer_kwargs() == ref.setup_trainer_kwargs()
    for dataset in ("Hecktor21", "BraTS21", "LITS"):
        a = cli.make_config(cli.build_parser().parse_args(["--dataset", dataset]))
        b = jconfig(jparser().parse_args(["--dataset", dataset]))
        assert a.__dict__ == b.__dict__
