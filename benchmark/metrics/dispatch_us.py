"""Mean host time of a HMatrix.matvec call, from the call to its return
(before the synchronize): the entry, the product wrapper and the
launches (host clock)."""


def read(rec):
    if rec.kind != "matvec" or not rec.count:
        return None
    return sum(r - i for i, r in zip(rec.t_issue, rec.t_return)) \
        / rec.count * 1e6
