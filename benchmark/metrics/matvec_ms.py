"""Mean wall time of a product: the window's wall time over the products
completed in it (host clock; each product ends in a synchronize)."""


def read(rec):
    if rec.kind != "matvec" or not rec.count:
        return None
    return rec.window_s / rec.count * 1e3
