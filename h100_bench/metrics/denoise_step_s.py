"""denoise_step_s: the pipeline's `denoise` phase seconds
(`last_timings`, card synced at its end) over its steps, all requests."""


def read(run):
    recs = [r for r in run.records if r["kind"] == "generate"]
    steps = sum(r["steps"] for r in recs)
    return sum(r["timings"]["denoise"] for r in recs) / steps if steps else None
