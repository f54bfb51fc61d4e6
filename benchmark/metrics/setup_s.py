"""Process start to the end of set-up: imports, loading (or building) the
native libraries, points, assembly, recompression, warm-up (host clock)."""


def read(rec):
    return rec.setup_s
