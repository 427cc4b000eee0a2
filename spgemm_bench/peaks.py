"""Published peaks of the chip the benchmark measures.

NVIDIA H100 SXM5 80GB (data sheet, at its full 700 W limit): HBM3 at
3.35 TB/s.  A card set below 700 W runs slower under load, so every result
carries the card's name and the harness reads its power limit.
"""
HBM_BYTES_PER_S = 3.35e12
