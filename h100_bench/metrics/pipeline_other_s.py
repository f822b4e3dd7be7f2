"""pipeline_other_s: a request's wall seconds less its denoise and VAE
phases (text, noise, post-processing, the engine's own work), a video."""


def read(run):
    recs = [r for r in run.records if r["kind"] == "generate"]
    if not recs:
        return None
    return sum(r["wall_s"] - r["timings"]["denoise"] - r["timings"]["vae"]
               for r in recs) / len(recs)
