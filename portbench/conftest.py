"""Small sizes of the benchmark's configurations and mixes for the CPU tests
(``pytest portbench``): the same model code at 32^3 (3-D) or 64^2 (2-D)
and transformer depth 4, computed in fp32 so that a sound run reads far
below every limit."""
import copy

import pytest

from portbench import spec


def small_config(name: str) -> dict:
    cfg = copy.deepcopy(spec.load("configs", name))
    nd = len(cfg["model"]["image_size"])
    edge = 32 if nd == 3 else 64
    cfg["model"].update(image_size=[edge] * nd, transformer_depth=4)
    cfg["patch_size"], cfg["step_size"] = [edge] * nd, [edge // 2] * nd
    cfg["train"]["batch_size"] = min(cfg["train"]["batch_size"], 4)
    cfg["compute_dtype"] = "float32"
    return cfg


def small_mix(cell: str, config: dict) -> dict:
    mix = spec.load("traffic", spec.cell(cell)["traffic"])
    edge = config["patch_size"][0]
    if mix["kind"] == "train":
        return dict(mix, cases=3 * config["train"]["batch_size"],
                    case_size=config["model"]["image_size"], num_workers=2)
    high = edge + edge // 2 if mix["size_high"] > mix["size_low"] else edge
    return dict(mix, size_low=edge + (high > edge), size_high=high, pool=3)


@pytest.fixture
def small():
    """(config, mix) of a cell at the tests' size."""
    def make(cell: str):
        cfg = small_config(spec.cell(cell)["config"])
        return cfg, small_mix(cell, cfg)
    return make
