"""video_s: the window's seconds over the videos it completed (every
phase of each generate inside it), host clock."""


def read(run):
    videos = [r for r in run.records if r["kind"] == "generate"]
    return run.window_s / len(videos) if videos else None
