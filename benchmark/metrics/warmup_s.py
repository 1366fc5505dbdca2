"""warmup_s: the harness's span around the entry point's warm-up: the
eager call, the call that captures the CUDA graph, one replay."""


def read(rec):
    return rec["spans"].get("warmup_s")
