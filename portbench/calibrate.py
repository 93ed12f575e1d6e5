#!/usr/bin/env python3
"""Find a configuration's white-noise amplitude on the card.

    python3 portbench/calibrate.py --config hurricane [--seed 0]

Bisects the amplitude (on a log scale) until the port's compression of
field 0, at the configuration's own shape and codec settings, lands within
``--tol`` of its Table IV ratio, by the benchmark's accounting.  Prints one
JSON line a step and the result; the amplitude and the ratio it gave are
then written into the configuration file by hand (``assumed``).
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tol", type=float, default=0.005)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--shape", type=int, nargs="*",
                   help="another field shape than the configuration's")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import accounting, fields, harness
    from repro_torch.core.codec import Codec, CodecConfig

    config = harness.load_config(args.config)
    target = float(config["table_iv"]["ratio"])
    codec = Codec(CodecConfig(**config["codec"]))
    shape = tuple(args.shape or config["shape"])

    def ratio_at(amp):
        x = fields.make(shape, amp, args.seed, 0, "cuda",
                        config["assumed"]["noise"])
        t = time.perf_counter()
        c = codec.compress(x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        fp = accounting.footprint(c)
        return accounting.ratio([fp]), fp, dt

    lo, hi = math.log(1e-5), math.log(100.0)
    best = None
    for step in range(args.steps):
        mid = 0.5 * (lo + hi)
        amp = float(f"{math.exp(mid):.6g}")
        r, fp, dt = ratio_at(amp)
        n = fp["original_bytes"] // 4
        print(json.dumps({"step": step, "noise_amp": amp, "ratio": r,
                          "payload_bits_per_value": fp["total_bits"] / n,
                          "outlier_share": fp["n_outliers"] / n,
                          "units": -(-fp["total_bits"] // 32),
                          "compress_s": dt}), flush=True)
        if best is None or abs(r - target) < abs(best[1] - target):
            best = (amp, r)
        if abs(r - target) / target < args.tol:
            break
        if r > target:
            lo = mid
        else:
            hi = mid
    print(json.dumps({"config": args.config, "target": target,
                      "noise_amp": best[0], "ratio": best[1],
                      "card": torch.cuda.get_device_name()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
