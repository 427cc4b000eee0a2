"""``triangles``: the masked plan is built and the mask staged in set-up
(``cached_executor(A, A, masked=True)``, ``stage_mask(A)``), and a call is
the public ``triangle_count(A)``, which finds them; an answer is the count,
and every call's is kept.  The control counts each wedge-closing edge once,
the boolean product's support, instead of with its multiplicity."""
from __future__ import annotations

import torch

from spgemm_bench import compare, gen, reference
from spgemm_bench.ops import Op as _Base
from spgemm_bench.ops import program_matrix


def _six_t(inputs, device, multiplicity=True) -> int:
    indptr, indices, n = inputs
    six_t = reference.triangle_sum(indptr, indices, n, device, multiplicity=multiplicity)
    if multiplicity and six_t % 6:
        raise ValueError(f"reference wedge sum {six_t} is not a multiple of 6: "
                         "the input is not a symmetric, hollow graph")
    return six_t


class Op(_Base):
    keep_every = True

    def __init__(self, mix: dict, inputs, device: torch.device, mesh=None):
        from binary_spgemm_tpu_torch.ops.ell import cached_executor

        self.device, self.a = device, program_matrix(inputs)
        self.flops = gen.flops(*inputs[:2])

        def build():
            ex = cached_executor(self.a, self.a, masked=True, device=device)
            ex.stage_mask(self.a)
            return ex

        self.ex = self._timed(build)

    def call(self):
        import binary_spgemm_tpu_torch as bt

        return bt.triangle_count(self.a, device=self.device)

    def answer(self, out):
        return int(out)

    def release(self) -> None:
        from binary_spgemm_tpu_torch.ops import ell

        super().release()
        ell._EXEC_CACHE.clear()  # the program's executor cache holds the plan

    def check(self, answers, inputs, device):
        return compare.compare_counts(answers, _six_t(inputs, device) // 6), {}

    @staticmethod
    def control(mix: dict, inputs, device):
        support = _six_t(inputs, device, multiplicity=False)
        return compare.compare_counts([support // 6], _six_t(inputs, device) // 6)
