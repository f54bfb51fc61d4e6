"""Peak device memory over set-up and window,
torch.cuda.max_memory_allocated(), read when the window closes and before
the check allocates anything."""


def read(rec):
    return None if rec.peak_bytes is None else rec.peak_bytes / 1e6
