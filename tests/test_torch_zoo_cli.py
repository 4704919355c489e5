"""A zoo model through the port's command line on the CPU (``--device cpu``).

``-m train --net da_unet`` for 2 short epochs of fold 1 of 2 on 4 synthetic
cases of 20^3 (16^3 patches, fp32), then ``-m inf-sw`` and ``-m eval``:

- the preset's rules hold for the zoo: no deep supervision (no
  "DenseFormer" in the name), FocalLoss for 2 classes;
- every BatchNorm runs in training mode exactly once an optimizer step (no
  recompute: remat is not applied to the zoo), and in eval mode for the
  startup report, validation and inference;
- the checkpoint carries the running statistics, moved off (0, 1);
- inf-sw's labels are ``predict_volume``'s under the checkpoint's weights
  and statistics in eval mode, and eval writes a row per case.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

from fixtures import make_case  # noqa: E402

from hdenseformer_tpu_torch import cli  # noqa: E402
from hdenseformer_tpu_torch.data.io import hdf5_reader  # noqa: E402
from hdenseformer_tpu_torch.data.transforms import PETandCTNormalize  # noqa: E402
from hdenseformer_tpu_torch.infer.sliding import predict_volume  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models.layers import BatchNorm  # noqa: E402
from hdenseformer_tpu_torch.train.checkpoint import get_weight_path, load_checkpoint  # noqa: E402

CASES = ("za", "zb", "zc", "zd")
COMMON = ["--dataset", "Hecktor21", "--net", "da_unet", "--input-shape", "16", "16", "16",
          "--step-size", "8", "8", "8", "--no-bf16", "--folds", "2", "--version", "vz",
          "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_da_unet_train_inf_sw_eval(tmp_path, monkeypatch):
    h5 = tmp_path / "h5"
    h5.mkdir()
    for i, name in enumerate(CASES):
        make_case(str(h5 / f"{name}.hdf5"), shape=(20, 20, 20), seed=i)
    monkeypatch.chdir(tmp_path)
    cfg = cli.make_config(cli.build_parser().parse_args(["-m", "train"] + COMMON))
    assert not cfg.use_ds and cfg.loss_fun == "FocalLoss"

    calls = {True: 0, False: 0}
    forward = BatchNorm.forward

    def counted(self, x, *args, **kwargs):  # packed levels pass the layout
        calls[self.training] += 1
        return forward(self, x, *args, **kwargs)

    monkeypatch.setattr(BatchNorm, "forward", counted)
    hist = cli.main(["-m", "train", "--data-path", str(h5), "--epochs", "2", "--fold", "1"]
                    + COMMON)
    n_bn = sum(isinstance(m, BatchNorm) for m in get_net(
        "da_unet", 2, 2, (16, 16, 16), device="cpu").modules())
    # 2 epochs of 1 step (2 training cases at batch 2); the startup report's
    # forward and one validation step an epoch in eval mode
    assert len(hist[0]["train_loss"]) == 2 and np.isfinite(hist[0]["train_loss"]).all()
    assert calls == {True: 2 * n_bn, False: 3 * n_bn}

    ckpt_dir = tmp_path / "ckpt" / "Hecktor21" / "3d_seg" / "vz" / "fold1"
    state = load_checkpoint(get_weight_path(str(ckpt_dir)))["model"]
    assert not torch.equal(state["inc.bn1.mean"], torch.zeros(32))
    assert not torch.equal(state["up4.bn2.var"], torch.ones(32))

    seg = tmp_path / "seg"
    written = cli.main(["-m", "inf-sw", "--test-path", str(h5), "--save-path", str(seg)]
                       + COMMON)
    assert sorted(os.path.basename(p) for p in written) == [f"{c}.npy" for c in CASES]
    net = get_net("da_unet", 2, 2, (16, 16, 16), device="cpu")
    net.load_state_dict(state)
    for name in CASES:
        image = PETandCTNormalize()({"image": hdf5_reader(str(h5 / f"{name}.hdf5"), "ct")})
        want = predict_volume(net, image["image"], (16,) * 3, (8,) * 3, 2, window_batch=8)
        np.testing.assert_array_equal(np.load(seg / f"{name}.npy"), want)
    rows = cli.main(["-m", "eval", "--test-path", str(h5), "--save-path", str(seg)])
    assert [r["case"] for r in rows] == list(CASES)
    assert os.path.exists(seg / "eval_results.json")
