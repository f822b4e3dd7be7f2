#!/usr/bin/env python3
"""The check's two readings on the card, for setting a cell's limits.

    python3 h100_bench/readings.py --workload <cell> --seeds 11,12,13 \
        [--control] [--text]

For each seed, as a run does (`run.measure`): the weights and the requests
from the seed, the program built and warmed up, one request through the
timed path, the program freed; then the numbers compared against the
float32 reference (the program's reading) and, with `--control`, the same
numbers with the reference computed with float8 products put in the
program's place (the control's reading). With `--text` only the text
encoder is built, from the same weights, and the first request's encodes
run through it as the pipeline runs them: the text number alone, a few
seconds a seed. One JSON line a seed on standard output. The benchmark's
own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import run as bench  # noqa: E402
from harness import text  # noqa: E402
from harness import traffic  # noqa: E402
from harness import weights as hw  # noqa: E402


def readings(cell: str, seed: int, control: bool, device=None, cfg=None,
             mix=None) -> dict:
    t0 = time.perf_counter()
    m = bench.measure(cell, seed, 0.0, False, device, cfg, mix)
    out = {"cell": cell, "seed": seed,
           "request_s": m.run.records[0]["wall_s"],
           "measure_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["program"] = {k: c["value"] for k, c in m.adapter.check(
        m.cfg, m.mix, seed, m.captures, m.device).items()}
    out["check_s"] = time.perf_counter() - t0
    if control:
        t0 = time.perf_counter()
        out["control"] = {k: c["value"] for k, c in m.adapter.check(
            m.cfg, m.mix, seed, m.captures, m.device,
            precision="fp8").items()}
        out["control_s"] = time.perf_counter() - t0
    return out


def text_readings(cell: str, seed: int, control: bool, device=None,
                  cfg=None, mix=None) -> dict:
    import torch

    from reference.common import no_tf32

    _, _, cfg0, mix0, adapter = bench.load_cell(cell)
    cfg = cfg0 if cfg is None else cfg
    mix = mix0 if mix is None else mix
    device = device or torch.device("cuda", 0)
    no_tf32()
    req = traffic.generate(mix, seed)[0]
    dtype = adapter.DTYPES[cfg["dtype"]]
    weights = hw.make(adapter.layouts(cfg), seed, device,
                      dtype)["text_encoder"]
    tok = text.tokenizer(cfg, mix, seed)
    length = cfg[adapter.TEXT_LENGTH]
    encoder = text.encoder(cfg, weights, tok, length, device, dtype)
    encodes = [(texts, encoder.encode(texts)[0])
               for texts in adapter.text_calls(req)]
    del encoder
    out = {"cell": cell, "seed": seed}
    for name, precision in [("program", "fp32")] + (
            [("control", "fp8")] if control else []):
        out[name] = {"text_rel": text.text_rel(
            cfg, weights, precision, tok, encodes, length,
            adapter.TEXT_LIVE_ONLY, device)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--text", action="store_true")
    args = p.parse_args(argv)
    bench.set_environment(bench.ROOT)
    read = text_readings if args.text else readings
    for s in args.seeds.split(","):
        print(json.dumps(read(args.workload, int(s), args.control)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
