"""The port's benchmark drivers, each run as a module on a card:

    python -m binary_spgemm_tpu_torch.benchmarks.pallas_sort     # P1 against torch.sort and K1
    python -m binary_spgemm_tpu_torch.benchmarks.ab_wruns        # P2: the run-skip network
    python -m binary_spgemm_tpu_torch.benchmarks.sort_rate_table # the sort rates utils/trace.py pins
    python -m binary_spgemm_tpu_torch.benchmarks.pallas_gather   # P3/P4 against torch.index_select

``pallas_sort --check`` runs on the CPU.  Every row goes through
:func:`_provenance.emit` into ``results.jsonl`` here (``sort_rate_table``:
``micro.jsonl``), or into the file given with ``--results``.
"""
