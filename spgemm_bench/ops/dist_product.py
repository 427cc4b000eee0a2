"""``dist_product`` (``b_layout``, ``balance``): one rank's share of the
row-partitioned C = A·A, staged as ``dist_spgemm``'s ELL path stages it,
and a call is its step (``dist_spgemm_ell``); an answer is every rank's step
gathered by ``dist_spgemm``'s own assembly.  One process a card; ``flops``
is the whole product's.  The control is the product's."""
from __future__ import annotations

import torch

from spgemm_bench import gen
from spgemm_bench.ops import Op as _Base
from spgemm_bench.ops import check_product, product_control, program_matrix


class Op(_Base):
    distributed = True

    def __init__(self, mix: dict, inputs, device: torch.device, mesh=None):
        from binary_spgemm_tpu_torch.parallel import dist_spgemm as ds

        a = program_matrix(inputs)
        self.ds, self.device, self.mesh, self.shape = ds, device, mesh, a.shape
        self.flops = gen.flops(*inputs[:2])
        self.sharded = mix["b_layout"] == "sharded"

        def build():
            plan = ds._ell_plan(a, a, mesh, mix["balance"], "ell",
                                b_tables=mix["b_layout"], allow_batched=True)
            return plan, ds._stage_ell(plan, mesh, self.sharded)

        self.plan, self.staged = self._timed(build)
        self.kw = ds._ell_kw(self.plan)

    def call(self):
        return self.ds.dist_spgemm_ell(*self.staged, mesh=self.mesh, n_cols=self.shape[1],
                                       gather_tables=self.sharded, **self.kw)

    def answer(self, step):
        c = self.ds._assemble(step, self.plan[7], self.shape, self.mesh)
        return c.indptr, c.indices, c.shape

    def release(self) -> None:
        self.staged = self.plan = None

    def check(self, answers, inputs, device):
        return check_product(answers, inputs, device)

    control = staticmethod(product_control)
