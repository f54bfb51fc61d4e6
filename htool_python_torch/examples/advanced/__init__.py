"""The reference's advanced examples (example/advanced/*.py) on the port:
user partitions, dense-block and low-rank hooks, custom local
operators."""
