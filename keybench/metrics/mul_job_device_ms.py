"""Device ms of all ops per 32,768-key mul job: the profiled windows'
device time over the jobs queued in them."""
from keybench import readers


def read(rec):
    jobs = sum(s["units"] for s in rec["samples"])
    if not jobs:
        return None
    return 1e3 * sum(readers.device_s(s) for s in rec["samples"]) / jobs
