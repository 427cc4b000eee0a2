"""``ktruss``: the k-truss of A (k from the mix) by the program's
device-resident peel.  Set-up first runs the plain reference's peel
(``ktruss_reference.py``), before the program stages anything: its rounds
give the yardstick's flops (the sum over the support rounds of the
Gustavson flops of G_r) and its truss the answer to check against.  Then A's
masked plan is built and A staged as its mask (``cached_executor(A, A,
masked=True)``, ``stage_mask(A)``), as ``triangles`` stages them.  A call
is the public ``k_truss(A, k, resident=True)`` from that staged input to the
fixpoint; an answer is the host CSR, and every call's is kept.  The
control is the reference's peel cut after its first round."""
from __future__ import annotations

import torch

from spgemm_bench import compare, ktruss_reference, roofline
from spgemm_bench.ops import Op as _Base
from spgemm_bench.ops import program_matrix


def _peel(mix, inputs, device, max_rounds=None):
    indptr, indices, n = inputs
    return ktruss_reference.peel(indptr, indices, n, int(mix["k"]), device,
                                 max_rounds=max_rounds)


def _judge(answers, truss, n: int, device):
    """``compare_product`` of each answer against the reference truss as
    one ``(0, n, keys)`` block; the largest of each number."""
    numbers = {}
    for ans in answers:
        got, _ = compare.compare_product(*ans, [(0, n, truss.keys)], n, device)
        for key, v in got.items():
            numbers[key] = max(numbers.get(key, 0), v)
    return numbers


class Op(_Base):
    keep_every = True

    def __init__(self, mix: dict, inputs, device: torch.device, mesh=None):
        from binary_spgemm_tpu_torch.ops.ell import cached_executor

        self.device, self.k = device, int(mix["k"])
        self.truss = _peel(mix, inputs, device)
        self.flops = sum(self.truss.flops)
        self.a = program_matrix(inputs)

        def build():
            ex = cached_executor(self.a, self.a, masked=True, device=device)
            ex.stage_mask(self.a)
            return ex

        self.ex = self._timed(build)

    def call(self):
        import binary_spgemm_tpu_torch as bt

        return bt.k_truss(self.a, self.k, resident=True, device=self.device)

    def answer(self, out):
        return out.indptr, out.indices, out.shape

    def release(self) -> None:
        from binary_spgemm_tpu_torch.ops import ell

        super().release()
        ell._EXEC_CACHE.clear()  # the program's executor cache holds the plan

    def check(self, answers, inputs, device):
        n, t = inputs[2], self.truss
        need = sum(roofline.csr_bytes(n, m) for m in t.nnz) + roofline.csr_bytes(
            n, len(t.indices))
        return _judge(answers, t, n, device), {"bytes_needed": need}

    @staticmethod
    def control(mix: dict, inputs, device):
        n = inputs[2]
        cut = _peel(mix, inputs, device, max_rounds=1)
        return _judge([(cut.indptr, cut.indices, (n, n))], _peel(mix, inputs, device), n,
                      device)
