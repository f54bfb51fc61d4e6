"""The product kernel's share of its roofline: the frozen yardstick's
least time of one product (harness/yardstick.py: unpadded stored bytes, x
and y once, the published peaks) over the kernel's device time a product
(metric kernel_ms)."""

from harness import spec, yardstick


def read(rec):
    ms = spec.metric_reader("kernel_ms").read(rec)
    if ms is None:
        return None
    c = rec.counters
    bound_s, _ = yardstick.product_bound(c["stored_bytes"], c["n"], c["n"],
                                        c["k"], c["itemsize"],
                                        c["is_complex"])
    return 100.0 * bound_s * 1e3 / ms
