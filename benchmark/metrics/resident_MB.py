"""Device memory the program holds when set-up ends,
torch.cuda.memory_allocated()."""


def read(rec):
    return None if rec.resident_bytes is None else rec.resident_bytes / 1e6
