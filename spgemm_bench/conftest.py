"""Tiny sizes for the configurations that came after the test copy's own
table (``tests/conftest.py``'s ``TINY``), added to it before any test runs.
The k-truss configuration is cut to scale 11, where k = 32 still peels six
rounds and keeps a nonempty truss, so that its control (the peel cut after
one round) differs from the reference."""
from spgemm_bench.tests import conftest as _tiny

_tiny.TINY.setdefault("g500-s15-ef16-ktruss32", {
    "generator": "kronecker", "structure_seed": 1, "scale": 11, "edge_factor": 16,
    "a": 0.57, "b": 0.19, "c": 0.19, "symmetric": True, "self_loops": False, "k": 32})
