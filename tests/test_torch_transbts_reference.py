"""The port's TransBTS against the benchmark's plain reference
(``portbench/families/transbts.py``), on CPU, at the published widths
(tokens of 512, 8 heads of 64, an MLP of 4,096, 4 layers) and 16^3 and 32^3
inputs (2^3 and 4^3 tokens), on weights from ``portbench.weights.start``:

- eval logits, the port on the fine grid (``s2d=False``) and packed
  (``s2d=None``: levels 0 and 1 at full rank), within 1e-4 max|ref|: both
  sides compute in fp32, the packed convs in another order;
- a training forward and backward with every dropout (the channel coin,
  the tokens', five a layer) drawn from one seeded generator on each side,
  the focal loss summed as ``FocalLoss``: the loss within 1e-5 and the
  running statistics within 1e-5 (BatchNorm moves them from the batch's
  values). On the fine grid, which runs the reference's operations, each
  leaf's gradient lies within 1e-4 of its largest element. Packed, each
  leaf's gradient norm lies within 5e-3 of the reference's: fp32 rounding
  alone moves some leaf's gradient by 2.1e-3 of its norm at 32^3, for the
  reference as for the system, against the reference in float64. A conv
  bias that a BatchNorm follows has a gradient of rounding alone: under
  1e-6 of the median leaf's norm in float64, but up to 3.6e-3 of it in
  fp32, of any sign on either side. Those leaves (under 1e-3 of the median
  by the float64 reference) are held within 1e-2 of the median leaf's norm;
- a state dict of either model loads into the other strictly, parameters
  and buffers;
- the program's counters of one training forward: ``attention.calls`` a
  layer, ``attention.score_elements`` layers * b * 8 * n^2 and
  ``dropout.drawn_elements`` every mask's elements.
"""
import copy

import pytest
import torch

from hdenseformer_tpu_torch.models import get_net
from hdenseformer_tpu_torch.utils.profiling import tracing
from portbench import spec, weights
from portbench.families import transbts as reference

SIZES = (16, 32)
LAYOUTS = {"fine": False, "packed": None}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(size: int) -> dict:
    cfg = spec.load("configs", "transbts-hecktor21")
    cfg["model"] = dict(cfg["model"], image_size=[size] * 3)
    return cfg


def _pair(size: int, s2d):
    cfg = _config(size)
    m = cfg["model"]
    ref = reference.build(cfg)
    params, buffers = weights.start(cfg, size, torch.device("cpu"))
    ref.load_state_dict({**params, **buffers}, strict=True)
    port = get_net(m["name"], m["in_channels"], m["num_classes"], tuple(m["image_size"]),
                   s2d=s2d, device="cpu")
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn((2, *m["image_size"], m["in_channels"]),
                    generator=torch.Generator().manual_seed(size + 1))
    return ref, port, x


def _close(got, want, rel):
    scale = float(want.detach().abs().max())
    torch.testing.assert_close(got.detach(), want.detach(), rtol=0, atol=rel * scale + 1e-6)


def test_the_configuration_has_the_published_widths():
    m = _config(144)["model"]
    ref = reference.build(_config(144), "meta")
    assert (m["embedding_dim"], m["num_heads"], m["hidden_dim"], m["num_layers"]) == (
        512, 8, 4096, 4)
    assert tuple(ref.position_embeddings.shape) == (m["tokens"], 512) == (18 ** 3, 512)
    assert sum(p.numel() for p in ref.parameters()) == 33611842


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("size", SIZES)
def test_eval_logits_match_the_reference(size, layout):
    ref, port, x = _pair(size, LAYOUTS[layout])
    with torch.no_grad():
        want = ref.eval()(x)[0]
        got = port.eval()(x)
    assert got.dtype == torch.float32 and got.shape == want.shape == (*x.shape[:-1], 2)
    _close(got, want, 1e-4)


def _step(net, forward, x, onehot, seed: int = 9):
    """The loss and gradients by leaf of one training forward of ``net``."""
    loss = reference.loss(forward(torch.Generator().manual_seed(seed)), onehot,
                          torch.ones(x.shape[0], dtype=x.dtype))
    names = [n for n, _ in net.named_parameters()]
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, list(net.parameters()))))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("size", SIZES)
def test_training_step_matches_the_reference(size, layout):
    ref, port, x = _pair(size, LAYOUTS[layout])
    onehot = torch.nn.functional.one_hot((x[..., 0] > 0.5).long(), 2).float()
    exact = copy.deepcopy(ref).double()
    _, truth = _step(exact, lambda g: exact.train()(x.double(), g), x.double(), onehot.double())
    loss, want = _step(ref, lambda g: ref.train()(x, g), x, onehot)
    got_loss, got = _step(port, lambda g: [port.train()(x, generator=g)], x, onehot)
    _close(got_loss, loss, 1e-5)
    assert set(want) == set(got)
    median = float(torch.tensor([float(g.norm()) for g in truth.values()]).median())
    for name, g in want.items():
        if float(truth[name].norm()) < 1e-3 * median:  # rounding alone
            torch.testing.assert_close(got[name], g, rtol=0, atol=1e-2 * median)
        elif layout == "fine":
            _close(got[name], g, 1e-4)
        else:
            assert float((got[name] - g).norm()) <= 5e-3 * float(g.norm()), name
    buffers = dict(port.named_buffers())
    for name, value in ref.named_buffers():
        torch.testing.assert_close(buffers[name], value, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_state_dicts_load_both_ways_strictly(layout):
    ref, port, x = _pair(16, LAYOUTS[layout])
    with torch.no_grad():
        port.train()(x, generator=torch.Generator().manual_seed(3))  # moves the buffers
    assert dict(port.named_buffers())["bn.var"].ne(1.0).any()
    ref.load_state_dict(port.state_dict(), strict=True)
    loaded = ref.state_dict()
    for name, value in port.state_dict().items():
        assert torch.equal(loaded[name], value), name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_counters_of_a_training_forward(layout):
    ref, port, x = _pair(32, LAYOUTS[layout])
    b, layers, heads, n, e, hidden = 2, 4, 8, 4 ** 3, 512, 4096
    with tracing() as recording, torch.no_grad():
        port.train()(x, generator=torch.Generator().manual_seed(3))
    assert recording.counters["attention.calls"] == layers
    assert recording.counters["attention.score_elements"] == layers * b * heads * n * n
    per_layer = b * heads * n * n + 3 * b * n * e + b * n * hidden
    assert recording.counters["dropout.drawn_elements"] == b * 16 + b * n * e + layers * per_layer
    names = [s.name for s in recording.spans]
    assert names == ["transbts.encoder", "transbts.transformer", "transbts.decoder"]
    with tracing() as recording, torch.no_grad():
        port.eval()(x)
    assert recording.counters == {"attention.calls": layers,
                                  "attention.score_elements": layers * b * heads * n * n}
