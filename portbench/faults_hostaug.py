"""Planted faults of the host-augmented 3-D feed, read at the mix's own
size, on the card, beside ``control.py``'s readings:

- ``rotation_sign``: each sample's rotation drawn as the loader draws it and
  applied with its sign flipped;
- ``shifted_generator``: sample i of an epoch augmented from sample i + 1's
  generator.

Each is judged by ``augment_gap`` against the reference's own batches, and
by the training numbers of the reference trained on the faulty batches
against the reference trained on its own.

    python3 portbench/faults_hostaug.py --config hdf3d-hecktor21 \\
        --traffic train-hostaug-24cases --seeds 11 12 13 [--out FILE]

Prints one JSON line a reading and writes them all to ``--out``.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import check, families, spec, traffic, weights  # noqa: E402
from portbench.drivers.train import host_batches  # noqa: E402
from portbench.reference import augment2d, exact  # noqa: E402
from portbench.reference.train import run_steps  # noqa: E402


class NegatedRotation:
    """A sample's generator whose third ``uniform(-5, 5)`` draw, the "tr"
    warp's angle after the two shifts, comes out negated."""

    def __init__(self, rng):
        self.rng, self.draws = rng, 0

    def integers(self, *args, **kwargs):
        return self.rng.integers(*args, **kwargs)

    def uniform(self, low=0.0, high=1.0, size=None):
        value = self.rng.uniform(low, high, size)
        if (low, high) == (-5, 5):
            self.draws += 1
            if self.draws == 3:
                return -value
        return value


FAULTS = {
    "rotation_sign": lambda seed, epoch, index: NegatedRotation(
        augment2d.sample_rng(seed, epoch, index)),
    "shifted_generator": lambda seed, epoch, index: augment2d.sample_rng(seed, epoch, index + 1),
}


def fault_readings(config: dict, mix: dict, seed: int, device) -> dict:
    tr, b, family = config["train"], config["train"]["batch_size"], families.of(config)
    store = {f"case{i:04d}": c for i, c in
             enumerate(traffic.train_cases(dict(mix, cases=3 * b), seed, device))}
    sound = host_batches(store, config, mix, seed, device)
    start, buffers = weights.start(config, seed, device)

    def steps(batches):
        net = family.build(config, device)
        net.load_state_dict({**start, **buffers}, strict=True)
        return run_steps(net, batches, seed, tr["lr"], tr["weight_decay"], loss_fn=family.loss)

    out = {}
    with exact():
        ref = steps(sound)
        for name, sample_rng in FAULTS.items():
            faulty = host_batches(store, config, mix, seed, device, sample_rng=sample_rng)
            out[name] = dict(check.train_readings(steps(faulty), ref, start),
                             augment_gap=check.augment_gap(
                                 [{"image": f["image"], "label": f["onehot"]} for f in faulty],
                                 sound))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: the readings are taken on the card", file=sys.stderr)
        return 2
    config, mix = spec.load("configs", args.config), spec.load("traffic", args.traffic)
    rows = []
    for seed in args.seeds:
        for side, readings in fault_readings(config, mix, seed, torch.device("cuda")).items():
            rows.append({"side": side, "seed": seed, **readings})
            print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
