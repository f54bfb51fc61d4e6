"""Distributed operators: local operators, the row-partitioned global
operator and its builders."""
