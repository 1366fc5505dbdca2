"""fwd_mrays: extension + shadow rays of every pass in the window (the
passes' own stats, summed on the device and read once after it) over the
window's wall seconds, in millions a second."""


def read(rec):
    w = rec["window"]
    if rec["kind"] != "progressive" or not w["seconds"]:
        return None
    return w["rays"] / w["seconds"] / 1e6
