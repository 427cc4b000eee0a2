"""``sort_ms`` (row sorts): device milliseconds a call in the sorts: K1's
kernels (``sort_rows_*``), and ``torch.sort``'s CUB radix passes with its
segment set-up and post-processing.  The slowest rank's."""
from spgemm_bench.classify import per_call

PATTERNS = [r"sort_rows_", r"RadixSort", r"SegmentedSort", r"sort_postprocess",
            r"fill_index_and_segment", r"fill_reverse_indices"]


def read(rec: dict):
    return per_call(rec, PATTERNS)
