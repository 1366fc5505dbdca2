"""fast_pass_ms.fwd: device milliseconds from one timed pass's end to the
next (CUDA events between passes), the median over the window's passes
within 1.08 times its fastest: the pace of a replayed pass in the faster
of the card's two states (PERF.md), steadier than fwd_mrays, which takes
both states in."""
import statistics

FAST = 1.08


def read(rec):
    ms = rec["window"].get("pass_ms") if rec["kind"] == "progressive" else None
    if not ms:
        return None
    lo = min(ms)
    return statistics.median(m for m in ms if m <= FAST * lo)
