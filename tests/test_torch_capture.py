"""The captured steps' host side on the CPU (``utils/graphs.py``,
``train.loop.CapturedTrainStep``), and checkpoints of a capturable
optimizer.

On a card a train step is one replay of a CUDA graph (tests/test_torch_cuda.py
holds the replays against the eager steps there); on the CPU the same
``CapturedCall`` runs its body directly on its static buffers, which lets
this file hold everything around the graph against ``make_train_step``:
the warm-up that leaves the state as it was, the static buffers a batch is
copied into, the generators seeded per step, the cloned outputs, one call
per batch shape, and the pad-and-masked last batch. HDenseFormer_16 at 32^3,
depth 4, fp32, remat on, dropout 0.5: bit for bit, since the arithmetic is
the eager step's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models import get_net  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import RematGraphRng  # noqa: E402
from hdenseformer_tpu_torch.models.layers import init_weights  # noqa: E402
from hdenseformer_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from hdenseformer_tpu_torch.train.loop import (  # noqa: E402
    CapturedEvalStep,
    CapturedTrainStep,
    SemanticSeg,
    TrainState,
    make_eval_step,
    make_train_step,
    pad_and_mask_batch,
    seed_generators,
)
from hdenseformer_tpu_torch.train.state import (  # noqa: E402
    get_optimizer,
    make_capturable,
    plain_state_dict,
)
from hdenseformer_tpu_torch.utils.graphs import GraphCache  # noqa: E402

N_CLS, SEED = 2, 5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state() -> TrainState:
    net = get_net("HDenseFormer_16", 2, N_CLS, (32, 32, 32), transformer_depth=4, device="cpu")
    init_weights(net, torch.Generator().manual_seed(0))
    assert net.remat
    return TrainState(net, get_optimizer("Adam", 1e-3, weight_decay=1e-4,
                                         params=net.parameters()))


def _host_batches() -> list:
    """Three host batches of at most 2 cases: two full, then a last one of
    1 that ``pad_and_mask_batch`` pads to 2 with weight 0."""
    rng = np.random.RandomState(1)
    out = []
    for n in (2, 2, 1):
        image = rng.randn(n, 32, 32, 32, 2).astype(np.float32)
        label = np.zeros((n, 32, 32, 32), np.int64)
        label[:, 8:20, 10:24, 6:18] = 1
        image[..., 0] += 2.0 * label
        out.append({"image": image, "label": np.eye(N_CLS, dtype=np.float32)[label]})
    return out


def test_captured_runner_equals_eager_steps_on_the_cpu():
    crit = get_loss("FocalLoss", use_ds=True)
    batches = [pad_and_mask_batch(b, 2, "cpu") for b in _host_batches()]
    assert batches[2]["weight"].tolist() == [1.0, 0.0]

    eager, gens, ref = _state(), (torch.Generator(), None), []
    step = make_train_step(crit, N_CLS)
    for batch in batches:
        seed_generators(gens, SEED, eager.step)
        eager, out = step(eager, batch, *gens)
        ref.append(out)

    state, gens, got = _state(), (torch.Generator(), None), []
    runner = CapturedTrainStep(crit, N_CLS, graphs=GraphCache())
    seed_generators(gens, SEED, state.step)
    before = [p.detach().clone() for p in state.model.parameters()]
    gen_state = gens[0].get_state()
    call = runner.prepare(state, batches[0], *gens)  # the warm-up: a step, then undone
    assert all(torch.equal(p, q) for p, q in zip(state.model.parameters(), before))
    assert torch.equal(gens[0].get_state(), gen_state)
    assert all(torch.count_nonzero(v) == 0 for st in state.optimizer.state.values()
               for v in st.values())
    assert all(p.grad is None for p in state.model.parameters())
    for batch in batches:
        seed_generators(gens, SEED, state.step)
        assert runner.prepare(state, batch, *gens) is call  # one call for one shape
        out = call.replay(batch)
        state.step += 1
        assert all(call.static[n] is not v and torch.equal(call.static[n], v)
                   for n, v in batch.items())
        got.append(out)
    assert runner.graphs.captured == 1 and state.step == eager.step == 3
    for g, r in zip(got, ref):
        assert set(g) == {"loss", "dice", "cm"}
        assert all(torch.equal(g[n], r[n]) for n in g)
    for p, q in zip(state.model.parameters(), eager.model.parameters()):
        assert torch.equal(p, q)
    # the outputs are clones: a later replay leaves the earlier ones as they were
    kept = {n: v.clone() for n, v in got[0].items()}
    call.replay(batches[1])
    assert all(torch.equal(got[0][n], kept[n]) for n in kept)

    host = _host_batches()
    three = {n: np.concatenate([host[0][n], host[2][n]]) for n in host[0]}
    other = pad_and_mask_batch(three, 2, "cpu")  # a batch of 3 stays 3: another shape
    assert runner.prepare(state, other, *gens) is not call
    assert runner.graphs.captured == 2


def test_captured_eval_step_and_the_cpu_fallback():
    """On the CPU the trainer's captured steps are the eager ones; the eval
    call's host side equals ``make_eval_step`` and keys by shape too."""
    crit = get_loss("FocalLoss", use_ds=True)
    batch = pad_and_mask_batch(_host_batches()[2], 2, "cpu")
    state, graphs = _state(), GraphCache()
    ev = CapturedEvalStep(crit, N_CLS, graphs)
    want = make_eval_step(crit, N_CLS)(state, batch)
    got = ev(state, batch)
    assert graphs.captured == 0  # the eager step: nothing captured on the CPU
    assert all(torch.equal(got[n], want[n]) for n in want)
    train = CapturedTrainStep(crit, N_CLS, graphs=graphs)
    gen = torch.Generator().manual_seed(0)
    state, out = train(state, batch, gen)
    assert state.step == 1 and graphs.captured == 0 and torch.isfinite(out["loss"])


def test_remat_graph_rng_needs_a_card_generator():
    with pytest.raises(ValueError, match="card"):
        RematGraphRng(torch.Generator())


def test_capturable_adam_state_loads_into_plain_adam_on_the_cpu(tmp_path):
    """A capturable Adam's state (rate and step counters as tensors, the
    flag set) saved and loaded into a plain Adam on the CPU: the next step
    equals that of a run that never was capturable. Through
    ``plain_state_dict`` at save (the trainer's) and at load
    (``SemanticSeg.load_pretrained``) alike."""
    torch.manual_seed(0)
    w = torch.randn(6, 5)

    def run():
        p = torch.nn.Parameter(w.clone())
        opt = get_optimizer("Adam", 1e-2, weight_decay=1e-4, params=[p])
        for i in range(2):
            opt.zero_grad()
            (p * (i + 1.0)).square().sum().backward()
            opt.step()
        return p, opt

    p, opt = run()
    make_capturable(opt, "cpu")
    raw = opt.state_dict()
    assert raw["param_groups"][0]["capturable"] and torch.is_tensor(raw["param_groups"][0]["lr"])
    plain = plain_state_dict(raw)
    assert [g["capturable"] for g in plain["param_groups"]] == [False, False]
    assert all(isinstance(g["lr"], float) for g in plain["param_groups"])
    assert plain_state_dict(plain)["param_groups"] == plain["param_groups"]

    ref_p, ref_opt = run()
    for loaded in (plain, load_checkpoint(_save(tmp_path, raw))["optimizer"]):
        q = torch.nn.Parameter(p.detach().clone())
        fresh = get_optimizer("Adam", 1e-2, weight_decay=1e-4, params=[q])
        fresh.load_state_dict(plain_state_dict(loaded))
        for pp, o in ((q, fresh), (ref_p, ref_opt)):
            o.zero_grad()
            (pp * 3.0).square().sum().backward()
            o.step()
        assert torch.equal(q, ref_p)
        ref_p, ref_opt = run()


@pytest.mark.parametrize("name", ["AdamW", "SGD"])
def test_capturable_optimizer_state_loads_into_a_plain_one_on_the_cpu(name):
    """AdamW and Nesterov SGD (``get_optimizer``'s other two) made
    capturable, then saved through ``plain_state_dict``: their groups equal
    a plain optimizer's but for the rate's float32 rounding (SGD's update
    back to torch's default), and a plain optimizer loaded from them steps
    as one that never was capturable, within that rounding."""
    torch.manual_seed(0)
    w, b = torch.randn(6, 5), torch.randn(5)

    def make(values=(w, b)):
        ps = [torch.nn.Parameter(v.detach().clone()) for v in values]
        return ps, get_optimizer(name, 1e-2, weight_decay=1e-4, params=ps)

    def step(ps, opt, i):
        opt.zero_grad()
        ((ps[0] * (i + 1.0)).square().sum() + ps[1].pow(3).sum()).backward()
        opt.step()

    ps, opt = make()
    ref_ps, ref_opt = make()
    for i in range(2):
        step(ps, opt, i)
        step(ref_ps, ref_opt, i)
    make_capturable(opt, "cpu")
    if name == "SGD":
        assert [(g["foreach"], g["fused"]) for g in opt.param_groups] == [(False, True)] * 2
    plain = plain_state_dict(opt.state_dict())
    want = ref_opt.state_dict()["param_groups"]
    assert [dict(g, lr=None) for g in plain["param_groups"]] == [dict(g, lr=None) for g in want]
    assert [g["lr"] for g in plain["param_groups"]] == [float(np.float32(1e-2))] * 2
    qs, fresh = make(ps)
    fresh.load_state_dict(plain)
    step(qs, fresh, 2)
    step(ref_ps, ref_opt, 2)
    for q, r in zip(qs, ref_ps):
        torch.testing.assert_close(q, r, rtol=1e-6, atol=1e-7)


def test_capturable_sgd_steps_as_plain_sgd_on_the_cpu():
    """Nesterov SGD with coupled decay made capturable (its rate a tensor,
    torch's fused update, which reads the rate on the card and so can be
    captured) takes the plain SGD's steps within fp32 rounding, momentum
    buffers included."""
    torch.manual_seed(0)
    w = torch.randn(6, 5)
    ps = [torch.nn.Parameter(w.clone()) for _ in range(2)]
    opts = [get_optimizer("SGD", 1e-2, weight_decay=1e-4, params=[p]) for p in ps]
    make_capturable(opts[0], "cpu")
    assert torch.is_tensor(opts[0].param_groups[0]["lr"])
    for i in range(3):
        g = torch.randn(6, 5)
        for p, opt in zip(ps, opts):
            p.grad = g.clone()
            opt.step()
        torch.testing.assert_close(ps[0], ps[1], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(opts[0].state[ps[0]]["momentum_buffer"],
                               opts[1].state[ps[1]]["momentum_buffer"], rtol=1e-6, atol=1e-7)


def _save(tmp_path, optimizer_state) -> str:
    path = str(tmp_path / "capturable.pt")
    save_checkpoint(path, {}, optimizer_state, epoch=0, step=2)
    return path


def test_semanticseg_capture_history_equals_eager_on_the_cpu(tmp_path):
    """``SemanticSeg(capture=True)`` (the default) on the CPU trains as
    ``capture=False``: the same history, and no graph captured."""
    pytest.importorskip("h5py")
    from fixtures import make_dataset_dir

    paths = make_dataset_dir(str(tmp_path / "cases"), n_cases=3, shape=(36, 36, 36))
    hist = {}
    for capture in (True, False):
        seg = SemanticSeg(net_name="HDenseFormer_16", channels=2, num_classes=2,
                          roi_number=None, input_shape=(32, 32, 32), patch_size=(32, 32, 32),
                          step_size=(16, 16, 16), batch_size=2, num_workers=0, use_fp16=False,
                          transformer_depth=2, transform_3d=[1, 2, 6], seed=3, n_epoch=1,
                          device="cpu", capture=capture)
        assert seg.capture is capture
        hist[capture] = seg.trainer(paths[:2], paths[2:], 1,
                                    output_dir=str(tmp_path / f"ckpt{capture}"),
                                    log_dir=str(tmp_path / f"log{capture}"),
                                    optimizer="Adam", loss_fun="FocalLoss", use_ds=True)
    assert hist[True] == hist[False]
    assert np.isfinite(hist[True]["train_loss"]).all()
