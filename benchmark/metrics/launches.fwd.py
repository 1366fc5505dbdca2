"""launches.fwd: device operations (kernels, copies, fills) of one
replayed forward pass, counted in the profiler's trace."""


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "progressive" or tr is None or not tr["dev"]:
        return None
    return len(tr["dev"]) / tr["passes"]
