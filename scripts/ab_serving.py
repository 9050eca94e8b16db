#!/usr/bin/env python3
"""Serving pairs/s of one checkout, for A/B runs of the serving cells.

    python3 scripts/ab_serving.py <root> [model@size ...]

run on a machine with a CUDA card, from any directory. It imports
chip_smoke.py and the port from <root> (a checkout, or a `git archive`
export of one under the gitignored build/), builds the kernels there, and
for each model (default: pvlt_tiny@256 and pvlt_swin_tiny@224) scores three
seeded bundles through the serving entry points (chip_smoke's phase_slice,
its launch checks included) and prints chip_smoke's throughput and profile
lines: pairs/s at B = 101 by CUDA events (median of 15 calls over 3
pre-staged bundles) and the device idle share of three calls. Alternate
the roots in one call (parent, change, change, parent, ...) to compare two
trees on one card; the Swin path at 224 is bound by host work, so its rate
moves with the host's load and wants more alternations than the
device-bound cells.
"""

import os
import sys


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import chip_smoke as c

    wrappers = {"pvlt_tiny": (c.SERVING_WRAPPERS, None, c.V1_GROUPS),
                "pvlt_swin_tiny": (c.SWIN_WRAPPERS,
                                   {"swin_block": 2, "swin_attention": 6, "ln_mlp_fwd": 6},
                                   c.SWIN_GROUPS)}
    c.phase_device()
    c.phase_build()
    stats = c.new_stats()
    for spec in sys.argv[2:] or ["pvlt_tiny@256", "pvlt_swin_tiny@224"]:
        name, size = spec.split("@")
        path, per_forward, groups = wrappers[name]
        if int(size) == 256 and name == "pvlt_swin_tiny":
            per_forward = {"swin_block": 8}
        prefix = f"{name}_{size}_"
        model, bundles, _ = c.phase_slice(stats, name, path, prefix + "slice", int(size),
                                          per_forward)
        c.phase_throughput(model, bundles, groups, prefix)
        del model
        c.torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
