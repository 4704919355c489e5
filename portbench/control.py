"""Readings that set a cell's limits of ``correct``, at the cell's own size,
on the card, in one process:

- the system's, from short runs of the cell (``--program-seeds``): what
  sound runs read;
- the control's (``--seeds``): the reference in the program's place,
  computed in a lower precision than the configuration states (fp8 for
  bf16: ``reference.model.quantise``), judged against the fp32 reference
  by the cell's own numbers; beside it the same in bf16, the stated
  precision, for comparison;
- planted faults, judged the same way: for training the reference
  learning from half of each batch (its loss scaled to the whole batch),
  and where the host augments, the reference's batches with the flips'
  axes swapped (W for H), judged by ``augment_gap``;
  for serving the labels of one window's corner block flipped, as an
  answer altered where it is produced. A step that leaves its state
  unchanged reads 1 by the training numbers' measure and needs no run.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 \\
        --program-seeds 21 22 ... [--seconds 2] [--out FILE]

Prints one JSON line a reading and writes them all to ``--out``.
"""
import argparse
import functools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import check, families, run, spec, traffic, weights  # noqa: E402
from portbench.drivers.serve import sample_of  # noqa: E402
from portbench.drivers.train import case_batch, host_batches  # noqa: E402
from portbench.reference import augment, exact  # noqa: E402
from portbench.reference import serve as ref_serve  # noqa: E402
from portbench.reference.train import run_steps  # noqa: E402


# the flips' axes swapped (W for H), as the host feed's planted fault: 2-D
# image axes, 3-D label axes (``reference.augment2d``, ``reference.augment3d``)
SWAPPED_FLIPS = {2: (-2, -1), 3: (2, 1)}


def train_controls(config: dict, mix: dict, seed: int, device) -> dict:
    tr, b, family = config["train"], config["train"]["batch_size"], families.of(config)
    store = {f"case{i:04d}": c for i, c in
             enumerate(traffic.train_cases(dict(mix, cases=3 * b), seed, device))}
    if mix["device_augment"]:
        batches = [case_batch(store, sorted(store)[t * b:(t + 1) * b], device) for t in range(3)]
        device_augment = functools.partial(augment.augment, patch=tuple(config["patch_size"]),
                                           num_classes=config["model"]["num_classes"])
    else:
        batches, device_augment = host_batches(store, config, mix, seed, device), None
    swapped = (None if mix["device_augment"] else
               host_batches(store, config, mix, seed, device, flip_axes=SWAPPED_FLIPS[
                   len(config["model"]["image_size"])]))
    start, buffers = weights.start(config, seed, device)

    def steps(precision, half_batch=False):
        net = family.build(config, device)
        net.load_state_dict({**start, **buffers}, strict=True)
        return run_steps(net.set_precision(precision), batches, seed, tr["lr"],
                         tr["weight_decay"], device_augment, half_batch=half_batch,
                         loss_fn=family.loss)

    out = {}
    with exact():
        ref = steps("fp32")
        for name, kw in (("bf16", dict(precision="bf16")), ("fp8", dict(precision="fp8")),
                         ("half_batch", dict(precision="fp32", half_batch=True))):
            out[name] = check.train_readings(steps(**kw), ref, start)
    if swapped is not None:
        out["swapped_flip"] = {"augment_gap": check.augment_gap(
            [{"image": b["image"], "label": b["onehot"]} for b in swapped], batches)}
    return out


def serve_controls(config: dict, mix: dict, seed: int, device) -> dict:
    m = config["model"]
    patch, step, ncls = tuple(config["patch_size"]), tuple(config["step_size"]), m["num_classes"]
    pool = traffic.serve_pool(mix, seed, device)
    start, buffers = weights.start(config, seed, device)
    out = {"bf16": [], "fp8": [], "flipped_block": []}
    with exact():
        net = families.of(config).build(config, device)
        net.load_state_dict({**start, **buffers}, strict=True)
        for i in sample_of(pool, mix, seed):
            volume = ref_serve.normalize(pool[i][0], device)
            probs = ref_serve.mean_probs(net.set_precision("fp32"), volume, patch, step, ncls)
            labels = probs.argmax(-1)
            corner = tuple(slice(0, p // 4) for p in patch)
            labels[corner] = ncls - 1 - labels[corner]
            out["flipped_block"].append(check.label_gap(labels, probs))
            for precision in ("bf16", "fp8"):
                low = ref_serve.mean_probs(net.set_precision(precision), volume, patch, step,
                                           ncls)
                out[precision].append(check.label_gap(low.argmax(-1), probs))
    return {k: {"label_gap": max(v)} for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: the readings are taken on the card", file=sys.stderr)
        return 2
    entry = spec.cell(args.workload)
    config, mix = spec.load("configs", entry["config"]), spec.load("traffic", entry["traffic"])
    device = torch.device("cuda")
    rows = []
    for seed in args.program_seeds:
        result = run.run(args.workload, seed, args.seconds, False, t_start=time.perf_counter())
        rows.append({"side": "program", "seed": seed, "correct": result["correct"],
                     **{k: c["value"] for k, c in result["checks"].items()},
                     **result["diagnostics"]})
        print(json.dumps(rows[-1]), flush=True)
    controls = train_controls if mix["kind"] == "train" else serve_controls
    for seed in args.seeds:
        for side, readings in controls(config, mix, seed, device).items():
            rows.append({"side": side, "seed": seed, **readings})
            print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
