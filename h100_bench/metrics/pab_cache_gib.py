"""pab_cache_gib: the PAB cache's bytes (`last_pab_cache_bytes`), GiB."""


def read(run):
    sizes = [r["pab_cache_bytes"] for r in run.records
             if "pab_cache_bytes" in r]
    return max(sizes) / 2**30 if sizes else None
