"""One rank of tests/test_torch_distributed.py's two-process gloo run, or
(with ``capture``) of tests/test_torch_mesh_capture.py's.

    python tests/torch_dp_worker.py WORK [capture]

Launched twice under the JAX package's env contract
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES=2``, ``JAX_PROCESS_ID``),
which ``parallel.mesh.maybe_distributed_init`` maps onto torch's. It imports
no JAX. In ``WORK`` it reads ``cases.json`` (the train-step cases), each
case's weights (``<case>.pt``) and global batch (``<case>.npz``), and
writes ``<case>.rank<r>.pt``: the metrics of one data-parallel step on its
share, the parameters and buffers after it. Then the sharded windows of
``predict_volume`` on ``volume.npy`` (``predict.rank<r>.npy``), and the CLI
under ``--n-devices 2``: ``-m train`` then ``-m inf-sw`` in ``WORK/cli``
(``cli.rank<r>.json``: the training history). The test's own process
builds the same models with ``build`` below.

With ``capture`` it runs ``capture_main``: for each case of
``CAPTURE_CASES``, two data-parallel train steps (``CAPTURE_SIZES``) and an
eval step, eagerly and through the host side of ``CapturedTrainStep`` /
``CapturedEvalStep`` from the same weights, and the captured calls' keys
and counts over ``KEY_SIZES``; it writes ``capture.rank<r>.pt``.
``spawn`` starts the two ranks of either run.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from hdenseformer_tpu_torch.losses import get_loss
from hdenseformer_tpu_torch.models import daunet, hdenseformer
from hdenseformer_tpu_torch.train.state import get_optimizer

N_CLS, LR, WD, BATCH = 2, 1e-3, 1e-4, 4
PLANE, VOXELS = (32, 32), (16, 16, 16)  # 2 x 2 tokens: at 16^2 one token is normalised away
DA_WIDTH = (8, 16, 32, 64, 128)
# the volume of the sharded windows: patch 16^3, step 8^3, JAX's test
WINDOW, WINDOW_STEP = (16, 16, 16), (8, 8, 8)
# the CLI's run: 4 cases of 24^3, a 16^3 patch, fold 1 of 2 (2 train cases in
# one padded batch of 4: rank 1's share is all padding), one epoch
CLI = ["--dataset", "Hecktor21", "--net", "HDenseFormer_16", "--input-shape", "16", "16", "16",
       "--step-size", "8", "8", "8", "--transformer-depth", "2", "--no-bf16", "--folds", "2",
       "--batch-size", "4", "--epochs", "1", "--fold", "1", "--version", "dp", "--device", "cpu"]


# the captured steps under the mesh: dropout drawn per rank from the global
# batch's mask, and BatchNorm's global statistics; two steps of a full
# global batch and a remainder of 3 (padded to 4), then the graph keys of
# batches of 4, 3, 1 and 5 (padded to 4, 4, 4, 6: two shapes)
CAPTURE_CASES = {
    "dropout": dict(net="hdf2d", loss="FocalLoss", dropout=0.5, seed=5),
    "batchnorm": dict(net="da_unet", loss="FocalLoss", dropout=0.0, seed=0),
}
CAPTURE_SIZES, KEY_SIZES = (4, 3), (4, 3, 1, 5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(work, *args) -> list:
    """Start the two gloo ranks (``main`` or, with ``capture``,
    ``capture_main``) on a free local port; returns the processes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                   GLOO_SOCKET_IFNAME="lo",  # keep gloo on the loopback interface
                   PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(work), *args],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def capture_batch(case: dict, n: int, i: int) -> dict:
    """Host batch ``i`` of ``n`` samples of a captured-step case."""
    spatial = VOXELS if case["net"] == "da_unet" else PLANE
    rng = np.random.RandomState(100 * i + n)
    labels = np.zeros((n,) + spatial, np.int64)
    labels[(slice(None),) + tuple(slice(4, 11) for _ in spatial)] = 1
    image = rng.randn(n, *spatial, 2).astype(np.float32)
    image[..., 0] += 2.0 * labels
    return {"image": image, "label": np.eye(N_CLS, dtype=np.float32)[labels]}


def build(case: dict) -> torch.nn.Module:
    """The port's model of a train-step case, on the CPU, in training mode."""
    if case["net"] == "da_unet":
        net = daunet.da_unet(VOXELS[0], 2, N_CLS, width=DA_WIDTH, dropout_flag=False,
                             device="cpu")
    else:
        net = hdenseformer.HDenseFormer_2D_16(2, N_CLS, PLANE, 4, dropout=case["dropout"],
                                              remat=False, device="cpu")
    return net.train()


def criterion(case: dict):
    return get_loss(case["loss"], topk=10, use_ds=case["net"] != "da_unet")


def optimizer(net: torch.nn.Module) -> torch.optim.Optimizer:
    return get_optimizer("SGD", LR, weight_decay=WD, momentum=0.9, params=net.parameters())


class ArgmaxNet(torch.nn.Module):
    """Logits (-10 x0, 10 x0): the label is x0 > 0, with a wide margin."""

    def __init__(self):
        super().__init__()
        self.unused = torch.nn.Parameter(torch.zeros(()))  # gives the model its device

    def forward(self, x):
        fg = x[..., :1] * 10.0
        return torch.cat([-fg, fg], dim=-1)


def main(work: str) -> None:
    from hdenseformer_tpu_torch import cli
    from hdenseformer_tpu_torch.infer.sliding import predict_volume
    from hdenseformer_tpu_torch.parallel.mesh import make_mesh, maybe_distributed_init
    from hdenseformer_tpu_torch.train.loop import TrainState, make_train_step, pad_and_mask_batch

    torch.set_num_threads(2)
    if not maybe_distributed_init("cpu"):
        raise SystemExit("no launch contract in the environment")
    mesh = make_mesh(2, "cpu")
    with open(os.path.join(work, "cases.json")) as f:
        cases = json.load(f)
    for name, case in cases.items():
        net = build(case)
        net.load_state_dict(torch.load(os.path.join(work, f"{name}.pt")))
        with np.load(os.path.join(work, f"{name}.npz")) as f:
            batch = dict(f)
        share = pad_and_mask_batch(batch, BATCH, mesh)
        step = make_train_step(criterion(case), N_CLS)
        with mesh:
            _, out = step(TrainState(net, optimizer(net)), share,
                          torch.Generator().manual_seed(case["seed"]))
        torch.save(dict(metrics={k: v.detach() for k, v in out.items()},
                        state={k: v.detach() for k, v in net.state_dict().items()},
                        weight=share["weight"]),
                   os.path.join(work, f"{name}.rank{mesh.rank}.pt"))

    volume = np.load(os.path.join(work, "volume.npy"))
    labels = predict_volume(ArgmaxNet(), volume, WINDOW, WINDOW_STEP, N_CLS, mesh=mesh)
    np.save(os.path.join(work, f"predict.rank{mesh.rank}.npy"), labels)

    os.chdir(os.path.join(work, "cli"))
    history = cli.main(["-m", "train", "--data-path", "../h5", "--n-devices", "2"] + CLI)
    cli.main(["-m", "inf-sw", "--test-path", "../h5", "--save-path", "seg", "--n-devices", "2"]
             + CLI)
    with open(os.path.join(work, f"cli.rank{mesh.rank}.json"), "w") as f:
        json.dump(history, f)
    print(f"rank {mesh.rank}: OK", flush=True)


def _detached(out: dict) -> dict:
    return {k: v.detach().clone() for k, v in out.items()}


def capture_main(work: str) -> None:
    from hdenseformer_tpu_torch.models.layers import init_weights
    from hdenseformer_tpu_torch.parallel.mesh import make_mesh, maybe_distributed_init
    from hdenseformer_tpu_torch.train.loop import (
        CapturedEvalStep,
        CapturedTrainStep,
        TrainState,
        make_eval_step,
        make_train_step,
        pad_and_mask_batch,
        step_seed,
    )
    from hdenseformer_tpu_torch.utils.graphs import batch_key

    torch.set_num_threads(2)
    if not maybe_distributed_init("cpu"):
        raise SystemExit("no launch contract in the environment")
    mesh = make_mesh(2, "cpu")
    result = {}
    for name, case in CAPTURE_CASES.items():
        crit = criterion(case)
        shares = [pad_and_mask_batch(capture_batch(case, n, i), BATCH, mesh)
                  for i, n in enumerate(CAPTURE_SIZES)]
        runs = {}
        for mode in ("eager", "captured"):
            net = build(case)
            init_weights(net, torch.Generator().manual_seed(case["seed"]))
            state, gen = TrainState(net, optimizer(net)), torch.Generator()
            step = make_train_step(crit, N_CLS) if mode == "eager" else CapturedTrainStep(
                crit, N_CLS)
            outs = []
            with mesh:
                for share in shares:
                    gen.manual_seed(step_seed(case["seed"], state.step))
                    if mode == "eager":
                        _, out = step(state, share, gen)
                    else:  # the host side of the graph: the body on static buffers
                        out = step.prepare(state, share, gen).replay(share)
                        state.step += 1
                    outs.append(_detached(out))
                ev = (make_eval_step(crit, N_CLS)(state, shares[-1]) if mode == "eager"
                      else CapturedEvalStep(crit, N_CLS).prepare(state, shares[-1])
                      .replay(shares[-1]))
            runs[mode] = dict(steps=outs, eval=_detached(ev),
                              state={k: v.detach().clone() for k, v in net.state_dict().items()})
        result[name] = runs

    case = CAPTURE_CASES["dropout"]
    net = build(case)
    init_weights(net, torch.Generator().manual_seed(case["seed"]))
    state, gen = TrainState(net, optimizer(net)), torch.Generator()
    runner, keys, counts = CapturedTrainStep(criterion(case), N_CLS), [], []
    with mesh:
        for i, n in enumerate(KEY_SIZES):
            share = pad_and_mask_batch(capture_batch(case, n, i), BATCH, mesh)
            gen.manual_seed(step_seed(case["seed"], state.step))
            runner.prepare(state, share, gen).replay(share)
            state.step += 1
            keys.append(repr(batch_key(share)))
            counts.append(runner.graphs.captured)
    result["keys"], result["counts"] = keys, counts
    torch.save(result, os.path.join(work, f"capture.rank{mesh.rank}.pt"))
    print(f"rank {mesh.rank}: OK", flush=True)


if __name__ == "__main__":
    if sys.argv[2:] == ["capture"]:
        capture_main(sys.argv[1])
    else:
        main(sys.argv[1])
