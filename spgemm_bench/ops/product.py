"""``product``: C = A·A through an executor built in set-up; a call is
``ex.run()``.  ``engine`` is ``"auto"`` (the program's ``auto_executor``)
or ``"esc"`` (its ``SpGEMMExecutor`` at the default chunk flops).  An
answer is the host CSR of the executor's own ``assemble``; the control is
the reference's C with its duplicates left in (the merge skipped)."""
from __future__ import annotations

import torch

from spgemm_bench import gen
from spgemm_bench.ops import Op as _Base
from spgemm_bench.ops import check_product, product_control, program_matrix


class Op(_Base):
    def __init__(self, mix: dict, inputs, device: torch.device, mesh=None):
        import binary_spgemm_tpu_torch as bt

        self.device = device
        self.flops = gen.flops(*inputs[:2])
        engines = {"auto": bt.auto_executor, "esc": bt.SpGEMMExecutor}
        if mix["engine"] not in engines:
            raise ValueError(f"unknown engine {mix['engine']!r} (have {sorted(engines)})")
        a = program_matrix(inputs)
        self.ex = self._timed(lambda: engines[mix["engine"]](a, a, device=device))

    def call(self):
        return self.ex.run()

    def answer(self, out):
        c = self.ex.assemble(out)
        return c.indptr, c.indices, c.shape

    def check(self, answers, inputs, device):
        return check_product(answers, inputs, device)

    control = staticmethod(product_control)
