"""``to_host``: C = A·A through the public one-shot ``spgemm(A, A)``, which
returns the product as a host CSR.  Set-up makes the one call that plans
and caches the executor (timed as ``plan_s``); a call is ``spgemm`` on that
cached plan, its assembly to the host included.  An answer is the host CSR
itself; the control is the reference's C with its duplicates left in (the
merge skipped)."""
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
        self.a = program_matrix(inputs)
        self._timed(lambda: bt.spgemm(self.a, self.a, device=device))

    def call(self):
        import binary_spgemm_tpu_torch as bt

        return bt.spgemm(self.a, self.a, device=self.device)

    def answer(self, out):
        return out.indptr, out.indices, out.shape

    def release(self) -> None:
        from binary_spgemm_tpu_torch.ops import ell

        super().release()
        ell._EXEC_CACHE.clear()  # the program's executor cache holds the plan

    def check(self, answers, inputs, device):
        return check_product(answers, inputs, device)

    control = staticmethod(product_control)
