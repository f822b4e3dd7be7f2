"""vae_s: the pipeline's `vae` phase seconds a video (`last_timings`)."""


def read(run):
    recs = [r for r in run.records if r["kind"] == "generate"]
    return sum(r["timings"]["vae"] for r in recs) / len(recs) if recs else None
