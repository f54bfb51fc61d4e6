"""Cluster tree and operator build, ended by a synchronize, during set-up
(host clock)."""


def read(rec):
    return rec.assembly_s
