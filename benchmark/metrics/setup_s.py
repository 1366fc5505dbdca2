"""setup_s: seconds from the process's start to the first timed call:
imports, scene generation and sync, kernel builds, warm-up and capture."""


def read(rec):
    return rec["spans"].get("setup_s")
