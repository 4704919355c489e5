#!/usr/bin/env python3
"""The packed levels of chip_smoke.py alone (its phase 4p), on one GPU.

    python3 time_packed.py [--seed 0] [--depth 24] [--kernels-only]

Builds the kernels, times the unshifted InstanceNorm forward at (8, 144^3,
32) and backward at (1, 144^3, 32) bf16 (device time, as phases 1 and 1b
do), then runs ``chip_smoke.phase_packed``: the shifted InstanceNorm kernels
against their plain versions at HDenseFormer_32's and HDenseFormer_2D_32's
level-0 serving shapes, and each packed model against its fine grid on the
same weights, timed in turns (``--kernels-only``: the shifted kernels alone,
``chip_smoke.shifted_kernel_checks``). Prints chip_smoke's JSON lines; exits
non-zero on any failed check, or without a CUDA device. About a minute on an
H100, where the whole chip_smoke.py takes four.
"""
import argparse
import sys
import time

import torch

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth", type=int, default=24, help="transformer_depth (24 = full)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="the shifted kernels' checks alone, not the packed models")
    args = ap.parse_args()
    args.patch, args.case, args.volume = cs.PATCH, cs.CASE, cs.VOLUME
    if not torch.cuda.is_available():
        print("time_packed: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    cs.phase_env(args)
    keys = ("ms", "bound_ms", "plain_ms")
    x = (torch.randn((cs.WINDOWS, cs.PATCH ** 3, 32), generator=gen, device="cuda") * 3
         + 1).to(torch.bfloat16)
    scale, bias = (torch.rand(32, generator=gen, device="cuda"),
                   torch.randn(32, generator=gen, device="cuda"))
    rec = cs.instance_norm_times(x, scale, bias, library=False)
    cs.emit("unshifted_forward", shape=list(x.shape), **{k: rec[k] for k in keys})
    del x
    x, dy, scale, bias = cs.norm_bwd_inputs(gen, (1, cs.PATCH ** 3, 32), torch.bfloat16, True)
    rec = cs.norm_backward_times(x, dy, scale, bias, True, library=False)
    cs.emit("unshifted_backward", shape=list(x.shape), **{k: rec[k] for k in keys})
    del x, dy
    if args.kernels_only:
        cs.emit("packed_kernels", **cs.shifted_kernel_checks(gen))
    else:
        main_shapes, by_path = cs.phase_packed(args, gen)
        cs.emit("packed_kernels", **main_shapes)
        cs.emit("packed_launches", **by_path)
    cs.emit("time_packed", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
