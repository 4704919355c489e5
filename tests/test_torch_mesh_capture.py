"""The captured data-parallel steps' host side on two gloo CPU ranks.

On a card under NCCL the trainer's steps are captured with their
collectives inside (``train.loop.CapturedTrainStep`` / ``CapturedEvalStep``
under ``with mesh:``); on the CPU the same ``CapturedCall`` runs its body on
its static buffers, which lets this file hold everything around the graph
against the eager mesh step. Two processes (``tests/torch_dp_worker.py
capture``, launched once for the file by its ``spawn``) form a world of 2
and each runs, from the same weights:

- two train steps (SGD, lr 1e-3, coupled L2 1e-4, global batches of 4 and
  of 3 padded to 4) of HDenseFormer_2D_16 at 32^2 (depth 4, dropout 0.5:
  each rank keeps its rows of the global batch's mask) and of da_unet at
  16^3 (BatchNorm's global statistics), then an eval step, eagerly and
  through the captured call's host side: equal bit for bit, metrics,
  parameters and running statistics (the arithmetic is the eager step's);
- the captured train step on global batches of 4, 3, 1 and 5: both ranks
  hold the same graph keys and capture on the same calls (a rank that
  captured while the other replayed would leave its collectives unmet).

In this process: ``check_capturable`` refuses gloo (and no backend) on a
card and names ``capture=False``, and lets NCCL, the CPU and a mesh that
does not reduce through; a world of one with ``always_reduce`` runs the
collectives (gloo, one rank): its captured step's host side equals its
eager step bit for bit, and both equal the step without a mesh within
1e-5 relative (the global paths sum in another order), and its
``predict_volume`` equals the one without a mesh on every voxel.
"""
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from hdenseformer_tpu_torch.infer.sliding import predict_volume  # noqa: E402
from hdenseformer_tpu_torch.models.layers import init_weights  # noqa: E402
from hdenseformer_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from hdenseformer_tpu_torch.train.loop import (  # noqa: E402
    CapturedEvalStep,
    CapturedTrainStep,
    TrainState,
    make_train_step,
    pad_and_mask_batch,
    step_seed,
)
from hdenseformer_tpu_torch.utils.graphs import model_graphs  # noqa: E402
from torch_dp_worker import (  # noqa: E402
    BATCH,
    CAPTURE_CASES,
    KEY_SIZES,
    N_CLS,
    WINDOW,
    WINDOW_STEP,
    ArgmaxNet,
    build,
    capture_batch,
    criterion,
    optimizer,
    spawn,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's ``capture.rank<r>.pt``."""
    work = tmp_path_factory.mktemp("mesh_capture")
    procs = spawn(work, "capture")
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [torch.load(work / f"capture.rank{r}.pt") for r in (0, 1)]


def _assert_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("name", sorted(CAPTURE_CASES))
def test_captured_mesh_steps_equal_eager_mesh_steps(ranks, name, rank):
    run = ranks[rank][name]
    assert len(run["captured"]["steps"]) == len(run["eager"]["steps"]) == 2
    for got, want in zip(run["captured"]["steps"], run["eager"]["steps"]):
        _assert_equal(got, want)
    _assert_equal(run["captured"]["state"], run["eager"]["state"])


@pytest.mark.parametrize("name", sorted(CAPTURE_CASES))
def test_captured_mesh_eval_step_equals_eager(ranks, name):
    for r in ranks:
        _assert_equal(r[name]["captured"]["eval"], r[name]["eager"]["eval"])


@pytest.mark.parametrize("name", sorted(CAPTURE_CASES))
def test_ranks_agree_under_capture(ranks, name):
    """The ranks' captured metrics are global and their parameters
    replicated: equal bit for bit."""
    a, b = ranks[0][name]["captured"], ranks[1][name]["captured"]
    for x, y in zip(a["steps"] + [a["eval"]], b["steps"] + [b["eval"]]):
        _assert_equal(x, y)
    _assert_equal(a["state"], b["state"])


def test_ranks_capture_on_the_same_call(ranks):
    """``pad_and_mask_batch``'s shares have one shape on every rank, so the
    graph keys agree and every rank captures on the same call: batches of
    4, 3 and 1 share the padded batch of 4's graph, 5 (padded to 6) makes
    the second."""
    assert ranks[0]["keys"] == ranks[1]["keys"]
    assert len(set(ranks[0]["keys"])) == 2 and len(ranks[0]["keys"]) == len(KEY_SIZES)
    assert ranks[0]["counts"] == ranks[1]["counts"] == [1, 1, 1, 2]


# --- in one process -----------------------------------------------------------------


@pytest.mark.parametrize("backend,world,always,device,refused", [
    ("gloo", 2, False, "cuda:0", True),
    (None, 2, False, "cuda:0", True),
    ("gloo", 1, True, "cuda:0", True),
    ("nccl", 2, False, "cuda:0", False),
    ("nccl", 1, True, "cuda:0", False),
    ("gloo", 2, False, "cpu", False),
    ("gloo", 1, False, "cuda:0", False),
], ids=["gloo", "no-world", "gloo-always-reduce", "nccl", "nccl-always-reduce", "cpu",
        "world-1"])
def test_check_capturable_refuses_host_collectives_on_a_card(monkeypatch, backend, world,
                                                            always, device, refused):
    """A graph on a card cannot hold gloo's collectives: the capture raises
    and names ``capture=False`` (no quiet fallback); NCCL, the CPU's host
    side and a mesh without collectives pass."""
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: backend is not None)
    monkeypatch.setattr(tmesh.dist, "get_backend", lambda *a: backend)
    mesh = tmesh.Mesh(0, world, device, always_reduce=always)
    if refused:
        with pytest.raises(RuntimeError, match="capture=False"):
            tmesh.check_capturable(mesh)
    else:
        tmesh.check_capturable(mesh)
    tmesh.check_capturable(None)


@pytest.mark.parametrize("call", ["train", "eval", "predict_volume"])
def test_capture_under_gloo_on_a_card_raises_before_any_work(monkeypatch, call):
    """The captured train and eval steps and ``predict_volume`` under a gloo
    mesh on a card raise before they build, warm up or run anything (the
    mesh names the card; the check reads only its device and backend)."""
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmesh.dist, "get_backend", lambda *a: "gloo")
    mesh = tmesh.Mesh(0, 2, "cuda:0")
    case = CAPTURE_CASES["dropout"]
    net = build(case)
    state = TrainState(net, optimizer(net))
    batch = pad_and_mask_batch(capture_batch(case, 2, 0), 2, "cpu")
    with mesh, pytest.raises(RuntimeError, match="capture=False"):
        if call == "train":
            CapturedTrainStep(criterion(case), N_CLS).prepare(state, batch, torch.Generator())
        elif call == "eval":
            CapturedEvalStep(criterion(case), N_CLS).prepare(state, batch)
        else:
            predict_volume(ArgmaxNet(), np.zeros((1, 16, 16, 16), np.float32), WINDOW,
                           WINDOW_STEP, N_CLS, mesh=mesh)
    assert not state.optimizer.state and model_graphs(net).captured == 0


@pytest.fixture
def world_of_one(monkeypatch):
    """A gloo process group of one rank in this process, torn down after."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        yield tmesh.make_mesh(1, "cpu", always_reduce=True)
    finally:
        dist.destroy_process_group()


def test_world_of_one_with_always_reduce_runs_the_collectives(world_of_one, monkeypatch):
    mesh = world_of_one
    calls = []
    reduce = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: calls.append(1) or reduce(
        t, *a, **k))
    with tmesh.Mesh(0, 1, "cpu"):
        assert tmesh.active_mesh() is None
    with mesh:
        assert tmesh.active_mesh() is mesh
    case = CAPTURE_CASES["dropout"]
    crit = criterion(case)
    share = pad_and_mask_batch(capture_batch(case, 3, 0), BATCH, mesh)
    outs = {}
    for mode in ("plain", "eager", "captured"):
        net = build(case)
        init_weights(net, torch.Generator().manual_seed(case["seed"]))
        state = TrainState(net, optimizer(net))
        gen = torch.Generator().manual_seed(step_seed(case["seed"], 0))
        n_calls = len(calls)
        if mode == "plain":
            _, out = make_train_step(crit, N_CLS)(state, share, gen)
            assert len(calls) == n_calls  # no mesh: no collective
        else:
            with mesh:
                if mode == "eager":
                    _, out = make_train_step(crit, N_CLS)(state, share, gen)
                else:
                    out = CapturedTrainStep(crit, N_CLS).prepare(state, share, gen).replay(share)
            assert len(calls) > n_calls
        outs[mode] = dict(metrics={k: v.detach() for k, v in out.items()},
                          params=[p.detach().clone() for p in net.parameters()])
    _assert_equal(outs["captured"]["metrics"], outs["eager"]["metrics"])
    assert all(torch.equal(p, q) for p, q in zip(outs["captured"]["params"],
                                                 outs["eager"]["params"]))
    for k in ("loss", "dice"):
        torch.testing.assert_close(outs["eager"]["metrics"][k], outs["plain"]["metrics"][k],
                                   rtol=1e-5, atol=0)
    assert torch.equal(outs["eager"]["metrics"]["cm"], outs["plain"]["metrics"]["cm"])
    for p, q in zip(outs["eager"]["params"], outs["plain"]["params"]):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-7)

    volume = np.random.RandomState(0).randn(1, 24, 20, 28).astype(np.float32)
    n_calls = len(calls)
    got = predict_volume(ArgmaxNet(), volume, WINDOW, WINDOW_STEP, N_CLS, mesh=mesh)
    assert len(calls) > n_calls  # the accumulator's all_reduce
    np.testing.assert_array_equal(
        got, predict_volume(ArgmaxNet(), volume, WINDOW, WINDOW_STEP, N_CLS))
