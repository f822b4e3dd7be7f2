"""step_mfu.serve: the model FLOPs the denoise steps execute (counted by
the configuration's own function from shapes, live caption tokens and the
PAB plan) over the denoise seconds times the card's bf16 peak, in %."""

from harness.roofline import PEAK_FLOPS


def read(run):
    recs = [r for r in run.records if r["kind"] == "generate"]
    seconds = sum(r["timings"]["denoise"] for r in recs)
    if not seconds:
        return None
    flops = sum(sum(r["step_flops"]) for r in recs)
    return 100.0 * flops / (seconds * PEAK_FLOPS["bf16"])
