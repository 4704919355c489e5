"""Data parallel over torch.distributed, two gloo processes on the CPU.

Modelled on tests/test_distributed.py: two processes (tests/
torch_dp_worker.py, launched once for the file under the JAX package's env
contract) form a world of 2 through ``parallel.mesh.maybe_distributed_init``
and each runs its share of:

- one train step (SGD, lr 1e-3, coupled L2 1e-4) of HDenseFormer_2D_16 at
  32^2 (depth 4, dropout 0) on a global batch of 4; on a remainder batch of
  3 real samples padded to 4, where the ranks' weight sums differ (2 and
  1); with the TopKLoss; of da_unet at 16^3 (BatchNorm, level 0 packed,
  running statistics); and of HDenseFormer_2D_16 with its dropout (0.5) on
  the remainder batch;
- ``predict_volume(mesh=...)`` of a random 32^3 volume with an argmax net;
- the CLI: ``-m train --n-devices 2`` (one epoch, fold 1: both training
  cases in one padded batch of 4, so rank 1's share is all padding) and
  ``-m inf-sw --n-devices 2``.

Each rank's step is held against the port's one-process step on the
global batch and against JAX's ``make_train_step`` on ``make_mesh(2)``
(conftest gives JAX 8 CPU devices) from the same weights, at the bars of
JAX's own ``test_dp_equivalence_one_vs_eight_devices``: losses and dice
within 1e-4 relative, the confusion matrix exactly, every parameter's
update (after - before) within 5e-2 of its norm plus 1e-2 of the largest
update's norm (a dropped or doubled shard moves an update by O(1/2)).
Running statistics within 1e-5 + 1e-4 |ref| (one step of momentum 0.1 on
E[x^2] - E[x]^2 over as few as 4 values a channel). The dropout case is
held against the port's one-process step only (JAX draws other masks): a
rank draws the global batch's mask and keeps its rows, so the two agree at
the same bars. The two ranks' metrics and parameters are equal bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hdenseformer_tpu.infer import sliding as jsliding  # noqa: E402
from hdenseformer_tpu.losses import losses as jlosses  # noqa: E402
from hdenseformer_tpu.models import daunet as jdaunet  # noqa: E402
from hdenseformer_tpu.models.hdenseformer import HDenseFormer as JaxHDenseFormer  # noqa: E402
from hdenseformer_tpu.parallel import mesh as jmesh  # noqa: E402
from hdenseformer_tpu.train import loop as jloop  # noqa: E402
from hdenseformer_tpu.train import state as jstate  # noqa: E402
from hdenseformer_tpu_torch import cli  # noqa: E402
from hdenseformer_tpu_torch.data.io import save_as_hdf5  # noqa: E402
from hdenseformer_tpu_torch.infer.sliding import predict_volume  # noqa: E402
from hdenseformer_tpu_torch.models.layers import init_weights  # noqa: E402
from hdenseformer_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from hdenseformer_tpu_torch.train.loop import (  # noqa: E402
    TrainState,
    make_train_step,
    pad_and_mask_batch,
)
from hdenseformer_tpu_torch.weights import (  # noqa: E402
    from_jax_batch_stats,
    from_jax_params,
    load_jax_params,
)
from torch_dp_worker import (  # noqa: E402
    BATCH,
    CLI,
    DA_WIDTH,
    LR,
    N_CLS,
    PLANE,
    VOXELS,
    WD,
    WINDOW,
    WINDOW_STEP,
    ArgmaxNet,
    build,
    criterion,
    optimizer,
    spawn,
)
from torch_port_util import random_jax_variables  # noqa: E402

CASES = {
    "batch4": dict(net="hdf2d", n=4, loss="FocalLoss", dropout=0.0, seed=0),
    "remainder": dict(net="hdf2d", n=3, loss="FocalLoss", dropout=0.0, seed=0),
    "topk": dict(net="hdf2d", n=4, loss="TopKLoss", dropout=0.0, seed=0),
    "batchnorm": dict(net="da_unet", n=4, loss="FocalLoss", dropout=0.0, seed=0),
    "dropout": dict(net="hdf2d", n=3, loss="FocalLoss", dropout=0.5, seed=5),
}
PATIENTS = ("pa", "pb", "pc", "pd")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(case: dict) -> dict:
    spatial = VOXELS if case["net"] == "da_unet" else PLANE
    rng = np.random.RandomState(len(case["loss"]) + case["n"])
    labels = np.zeros((case["n"],) + spatial, np.int64)
    labels[(slice(None),) + tuple(slice(4, 11) for _ in spatial)] = 1
    labels[1, 2:6, 3:9] = 1  # a second object in sample 1
    return {"image": rng.randn(case["n"], *spatial, 2).astype(np.float32),
            "label": np.eye(N_CLS, dtype=np.float32)[labels]}


def _jax_model(case: dict):
    if case["net"] == "da_unet":
        return jdaunet.da_unet(VOXELS[0], 2, N_CLS, width=DA_WIDTH, dropout_flag=False)
    return JaxHDenseFormer(in_channels=2, n_cls=N_CLS, n_filters=16, image_size=PLANE,
                           transformer_depth=4, dropout=0.0, remat=False)


def _jax_step(case: dict, variables: dict, batch: dict):
    """JAX's train step on its 2-device mesh: metrics, parameters, statistics."""
    jmodel = _jax_model(case)
    stats = variables.get("batch_stats")
    state = jstate.TrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        tx=jstate.get_optimizer("SGD", LR, weight_decay=WD, momentum=0.9),
        model_state={"batch_stats": stats} if stats else {})
    crit = jlosses.get_loss(case["loss"], topk=10, use_ds=case["net"] != "da_unet")
    mesh = jmesh.make_mesh(2)
    sharded = jloop.pad_and_mask_batch(batch, BATCH, mesh)
    new, metrics = jloop.make_train_step(crit, N_CLS)(state, sharded, jax.random.PRNGKey(0))
    return jax.device_get((metrics, new.params, new.model_state))


def _write_cases(root) -> None:
    os.makedirs(root / "h5")
    rng = np.random.default_rng(0)
    grid = np.indices((24,) * 3) - 12
    for i, pid in enumerate(PATIENTS):
        ball = np.sqrt((grid ** 2).sum(0)) < 5 + i
        image = np.stack([rng.normal(0, 200, ball.shape) + 300 * ball,
                          rng.gamma(2, 100, ball.shape) + 800 * ball]).astype(np.int16)
        save_as_hdf5(image, str(root / "h5" / f"{pid}.hdf5"), "ct")
        save_as_hdf5(ball.astype(np.uint8), str(root / "h5" / f"{pid}.hdf5"), "seg")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Everything both worlds computed: the two ranks' (read from their
    files), the port's one process and JAX's 2-device mesh."""
    work = tmp_path_factory.mktemp("dp")
    batches, variables = {}, {}
    for name, case in CASES.items():
        batches[name] = _batch(case)
        net = build(case)
        if case["dropout"]:  # port against port: the port's own initialisation
            init_weights(net, torch.Generator().manual_seed(case["seed"]))
        else:
            x0 = jnp.zeros((1,) + batches[name]["image"].shape[1:], jnp.float32)
            variables[name] = random_jax_variables(_jax_model(case), x0,
                                                   np.random.RandomState(1))
            load_jax_params(net, variables[name]["params"],
                            variables[name].get("batch_stats") or None)
        torch.save(net.state_dict(), work / f"{name}.pt")
        np.savez(work / f"{name}.npz", **batches[name])
    with open(work / "cases.json", "w") as f:
        json.dump(CASES, f)
    volume = np.random.RandomState(0).randn(1, 32, 32, 32).astype(np.float32)
    np.save(work / "volume.npy", volume)
    _write_cases(work)
    os.makedirs(work / "cli")
    procs = spawn(work)
    try:
        single, jax_runs = {}, {}
        for name, case in CASES.items():
            net = build(case)
            net.load_state_dict(torch.load(work / f"{name}.pt"))
            before = {k: v.clone() for k, v in net.state_dict().items()}
            _, out = make_train_step(criterion(case), N_CLS)(
                TrainState(net, optimizer(net)),
                pad_and_mask_batch(batches[name], BATCH, "cpu"),
                torch.Generator().manual_seed(case["seed"]))
            single[name] = dict(metrics=out, state=net.state_dict(), before=before)
            if name in variables:
                jm, jparams, jstats = _jax_step(case, variables[name], batches[name])
                jax_runs[name] = dict(
                    metrics=jm, params=from_jax_params(jparams, model=net),
                    stats=from_jax_batch_stats(jstats.get("batch_stats", {})))
        argmax_single = predict_volume(ArgmaxNet(), volume, WINDOW, WINDOW_STEP, N_CLS)
        argmax_jax = jsliding.predict_volume(_JaxArgmaxNet(), {}, volume, WINDOW, WINDOW_STEP,
                                             N_CLS, mesh=jmesh.make_mesh(2))
        cwd = os.getcwd()
        os.makedirs(work / "single")
        os.chdir(work / "single")
        try:
            history = cli.main(["-m", "train", "--data-path", "../h5"] + CLI)
        finally:
            os.chdir(cwd)
    finally:
        outs = [p.communicate(timeout=500)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    # the 2-rank run's checkpoint served by one process, for the files
    os.chdir(work / "cli")
    try:
        cli.main(["-m", "inf-sw", "--test-path", "../h5", "--save-path", "../seg_single"] + CLI)
    finally:
        os.chdir(cwd)
    ranks = [{name: torch.load(work / f"{name}.rank{r}.pt") for name in CASES} for r in (0, 1)]
    return dict(work=work, single=single, jax=jax_runs, ranks=ranks, history=history,
                argmax_single=argmax_single, argmax_jax=argmax_jax,
                cli_ranks=[json.load(open(work / f"cli.rank{r}.json")) for r in (0, 1)],
                argmax_ranks=[np.load(work / f"predict.rank{r}.npy") for r in (0, 1)])


class _JaxArgmaxNet:
    """The argmax net of tests/test_sliding.py, as a flax-free ``apply``."""

    @staticmethod
    def apply(variables, x, train=False):
        fg = x[..., :1] * 10.0
        return jnp.concatenate([-fg, fg], axis=-1)


def _assert_metrics(got: dict, ref: dict) -> None:
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["dice"]), float(ref["dice"]), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(got["cm"]), np.asarray(ref["cm"]))


def _assert_updates(before: dict, got: dict, ref: dict) -> None:
    """JAX's DP bar: |d_got - d_ref| < 5e-2 |d_ref| + 1e-2 max |d_ref|."""
    deltas = {k: (got[k].double() - before[k].double(), ref[k].double() - before[k].double())
              for k in ref}
    floor = 1e-2 * max(float(dr.norm()) for _, dr in deltas.values())
    for k, (dg, dr) in deltas.items():
        err = float((dg - dr).norm())
        assert err < 5e-2 * float(dr.norm()) + floor, (k, err, float(dr.norm()), floor)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_agree_bit_for_bit(run, name):
    r0, r1 = run["ranks"][0][name], run["ranks"][1][name]
    for k in ("loss", "dice", "cm"):
        assert torch.equal(r0["metrics"][k], r1["metrics"][k]), k
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_rank_step_equals_one_process_step(run, name):
    got, one = run["ranks"][0][name], run["single"][name]
    _assert_metrics(got["metrics"], one["metrics"])
    params = {k for k, _ in build(CASES[name]).named_parameters()}
    _assert_updates(one["before"], {k: got["state"][k] for k in params},
                    {k: one["state"][k] for k in params})
    for k, v in one["state"].items():  # BatchNorm's running statistics
        if k not in params:
            torch.testing.assert_close(got["state"][k], v, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if not c["dropout"]))
def test_two_rank_step_equals_jax_sharded_step(run, name):
    got, ref = run["ranks"][0][name], run["jax"][name]
    _assert_metrics(got["metrics"], ref["metrics"])
    before = run["single"][name]["before"]
    _assert_updates(before, {k: got["state"][k] for k in ref["params"]}, ref["params"])
    for k, v in ref["stats"].items():
        torch.testing.assert_close(got["state"][k], v, rtol=1e-4, atol=1e-5)


def test_remainder_shares_have_unequal_weights(run):
    """3 real samples padded to 4: rank 0 holds two, rank 1 one and a pad."""
    assert [r["remainder"]["weight"].tolist() for r in run["ranks"]] == [[1, 1], [1, 0]]


def test_predict_volume_sharded_matches_single_and_jax(run):
    for labels in run["argmax_ranks"]:
        np.testing.assert_array_equal(labels, run["argmax_single"])
        np.testing.assert_array_equal(labels, np.asarray(run["argmax_jax"]))


def test_cli_two_ranks_train_as_one_process(run):
    """``-m train --n-devices 2``: each rank's history equals the other's and,
    within 1e-4 relative, the one-process run's (dropout 0.5 on: the masks
    are the same); only rank 0 wrote the checkpoints and metrics."""
    h0, h1 = run["cli_ranks"]
    assert h0 == h1
    (one,) = run["history"]
    for k in ("train_loss", "val_loss", "train_dice", "val_dice"):
        np.testing.assert_allclose(h0[0][k], one[k], rtol=1e-4, err_msg=k)
    fold = run["work"] / "cli" / "ckpt" / "Hecktor21" / "3d_seg" / "dp" / "fold1"
    assert len(os.listdir(fold)) == 1
    log = run["work"] / "cli" / "log" / "Hecktor21" / "3d_seg" / "dp" / "fold1"
    with open(log / "metrics.jsonl") as f:  # one writer: each tag once an epoch
        tags = [json.loads(line)["tag"] for line in f]
    assert len(tags) == len(set(tags))


def test_cli_two_rank_inf_sw_writes_the_one_process_files(run):
    got, want = run["work"] / "cli" / "seg", run["work"] / "seg_single"
    assert sorted(os.listdir(got)) == sorted(os.listdir(want)) == [
        f"{p}.npy" for p in PATIENTS]
    for name in os.listdir(want):
        np.testing.assert_array_equal(np.load(got / name), np.load(want / name))


# --- in one process -----------------------------------------------------------------


@pytest.mark.parametrize("real,batch_size,world", [
    (4, 4, 2), (3, 4, 2), (1, 4, 2), (5, 4, 2), (3, 2, 4), (2, 6, 4)])
def test_pad_and_mask_batch_matches_jax(real, batch_size, world):
    """Each rank's share is its slice of JAX's padded global batch, weights
    included (``_put_batch``'s shapes)."""
    rng = np.random.RandomState(real)
    batch = {"image": rng.randn(real, 4, 4, 2).astype(np.float32),
             "label": rng.rand(real, 4, 4, 2).astype(np.float32)}
    jbatch = jloop.pad_and_mask_batch(batch, batch_size, jmesh.make_mesh(world))
    for rank in range(world):
        share = pad_and_mask_batch(batch, batch_size, tmesh.Mesh(rank, world, "cpu"))
        n = share["weight"].shape[0]
        assert n * world == jbatch["weight"].shape[0]
        for k, v in jbatch.items():
            np.testing.assert_array_equal(share[k].numpy(),
                                          np.asarray(v)[rank * n:(rank + 1) * n], err_msg=k)


TORCHRUN = dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT="29555")
JAXENV = dict(JAX_COORDINATOR_ADDRESS="127.0.0.1:29556", JAX_NUM_PROCESSES="2",
              JAX_PROCESS_ID="1")


@pytest.mark.parametrize("env,expect", [
    (TORCHRUN, dict(init_method="env://", backend="gloo")),
    (JAXENV, dict(init_method="tcp://127.0.0.1:29556", world_size=2, rank=1,
                  backend="gloo")),
    ({}, None),
], ids=["torchrun", "jax", "none"])
def test_maybe_distributed_init_reads_each_env_contract(monkeypatch, env, expect):
    for k in list(TORCHRUN) + list(JAXENV):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tmesh.dist, "init_process_group", lambda **kw: seen.append(kw))
    assert tmesh.maybe_distributed_init("cpu") is (expect is not None)
    assert seen == ([expect] if expect else [])


def test_maybe_distributed_init_needs_the_jax_counts(monkeypatch):
    for k in list(TORCHRUN) + list(JAXENV):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: False)
    with pytest.raises(ValueError, match="JAX_NUM_PROCESSES"):
        tmesh.maybe_distributed_init("cpu")


def test_make_mesh_without_a_card_raises(monkeypatch):
    """No quiet fallback to the host: without a card, make_mesh() (device
    None), local_device(None) and local_mesh_devices() raise, as get_net
    does; device="cpu" is how a caller asks for the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tmesh.make_mesh, tmesh.local_device, tmesh.local_mesh_devices):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.device) == (0, 1, torch.device("cpu"))
    assert tmesh.local_device("cpu") == torch.device("cpu")


def test_make_mesh_is_one_rank_without_a_world():
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.device) == (0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="needs 2 processes"):
        tmesh.make_mesh(2, "cpu")
    with mesh:  # a world of one: every helper is the identity
        assert tmesh.active_mesh() is None
