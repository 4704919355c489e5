"""The plain reference against the system at small sizes on the CPU: the
same weights give the same forward, in eval and in training with the same
dropout generator, fine-grid and packed."""
import pytest
import torch

from hdenseformer_tpu_torch.models import get_net
from portbench import weights
from portbench.conftest import small_config
from portbench.reference import model as ref_model
from portbench.reference import serve as ref_serve


def _pair(name: str, s2d):
    cfg = small_config(name)
    m = cfg["model"]
    ref = ref_model.build(cfg)
    start = weights.make(weights.shapes_of(ref), 7, torch.device("cpu"))
    ref.load_state_dict(start)
    port = get_net(m["name"], m["in_channels"], m["num_classes"], tuple(m["image_size"]),
                   transformer_depth=m["transformer_depth"], remat=False, s2d=s2d,
                   device="cpu")
    port.load_state_dict(start, strict=True)
    x = torch.randn((2, *m["image_size"], m["in_channels"]),
                    generator=torch.Generator().manual_seed(5))
    return ref, port, x


@pytest.mark.parametrize("name,s2d", [("hdf3d-hecktor21", False), ("hdf3d-hecktor21", None),
                                      ("hdf2d-picai22", None)])
def test_forward_equals_the_system(name, s2d):
    ref, port, x = _pair(name, s2d)
    with torch.no_grad():
        for got, want in zip(port.eval()(x), ref.eval()(x)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        for got, want in zip(port.train()(x, generator=torch.Generator().manual_seed(3)),
                             ref.train()(x, torch.Generator().manual_seed(3))):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_precision_changes_the_forward():
    ref, _, x = _pair("hdf3d-hecktor21", False)
    with torch.no_grad():
        exact = ref.eval()(x)[0]
        gaps = {p: float((ref.set_precision(p)(x)[0] - exact).abs().max()) for p in ("bf16", "fp8")}
    assert 0 < gaps["bf16"] < gaps["fp8"]
    with pytest.raises(ValueError):
        ref.set_precision("fp4")


def test_window_grid():
    assert ref_serve.origins((200, 144, 145), (144,) * 3, (72,) * 3) == [
        (0, 0, 0), (0, 0, 1), (56, 0, 0), (56, 0, 1)]
