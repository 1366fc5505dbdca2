"""slow_share.fwd: the share of the window's passes, in percent, whose
device milliseconds from the previous pass's end (CUDA events between
passes) exceed 1.08 times the window's fastest: the time a run spends in
the slower of the card's two states (PERF.md)."""

FAST = 1.08


def read(rec):
    ms = rec["window"].get("pass_ms") if rec["kind"] == "progressive" else None
    if not ms:
        return None
    lo = min(ms)
    return 100.0 * sum(m > FAST * lo for m in ms) / len(ms)
