"""attn_roofline.serve: the attention calls' roofline-bound seconds (each
op's work from its shapes and live keys, `harness.roofline`) over their
device seconds (the kernels found in each call's range in the trace), in %.
"""


def read(run):
    calls = run.attn or []
    device = sum(c["device_s"] for c in calls)
    if not calls or device <= 0:
        return None
    return 100.0 * sum(c["bound_s"] for c in calls) / device
