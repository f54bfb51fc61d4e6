"""Device time of the product kernel (K1 on float32 data, K2 on complex64:
`hmatrix_product_kernel`) a product, over the traced window."""

KERNEL = "hmatrix_product_kernel"


def read(rec):
    if rec.kind != "matvec" or rec.trace is None or not rec.count:
        return None
    sec = sum(s for name, (s, _) in rec.trace.by_name.items()
              if KERNEL in name)
    return sec / rec.count * 1e3 if sec > 0 else None
