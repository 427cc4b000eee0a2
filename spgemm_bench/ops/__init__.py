"""The one general driver of the traffic mixes: what a call of the closed
loop does, and how its answers are judged.

A mix (``mixes/<traffic>.json``) is data: the ``op`` it drives and that
op's parameters.  An op is a file of its own, ``ops/<op>.py``, found by that
name as the metric files are, so a new kind of call is a new file.  It
defines ``Op(mix, inputs, device, mesh)``, a subclass of :class:`Op`, which
stages the program's call on the generated ``inputs`` in set-up and gives:

* ``flops``: the Gustavson flops of one call, by the yardstick's count;
* ``call()``: one call of the closed loop (the harness synchronises);
* ``answer(out)``: a kept call's output as the check reads it;
* ``check(answers, inputs, device)``: ``(numbers, extra)`` against the
  plain reference, each number compared with its limit in ``compare.py``;
* ``control(mix, inputs, device)`` (a static method): the numbers that
  the reference with one guarantee broken gives in the program's place;
* ``distributed``: true where a run is one process a card (``launch``).

Every op times its construction (``plan_s``).
"""
from __future__ import annotations

import re
import time
from pathlib import Path

import numpy as np
import torch

from .. import compare, reference, roofline

__all__ = ["Op", "check_product", "csr_of_blocks", "load", "make", "product_control",
           "program_matrix"]

_NAME = re.compile(r"[A-Za-z][A-Za-z0-9_]*\Z")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_matrix(inputs):
    """The program's ``BCSR`` of the generated matrix, on copies of the
    arrays, so that the reference reads what the generator made."""
    from binary_spgemm_tpu_torch import BCSR

    indptr, indices, n = inputs
    return BCSR(indptr.copy(), indices.copy(), (n, n))


class Op:
    #: one process a card, started by the program's ``launch``
    distributed = False
    #: keep every call's answer (small) rather than one sampled output
    keep_every = False

    def _timed(self, build):
        """``build()``, its host seconds to the synchronise kept as ``plan_s``."""
        t0 = time.perf_counter()
        out = build()
        _sync(self.device)
        self.plan_s = time.perf_counter() - t0
        return out

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.__dict__.pop("ex", None)


def check_product(answers, inputs, device):
    """``(numbers, extra)`` of the program's CSR answers, each
    ``(indptr, indices, shape)``, against the reference's C = A·A; ``extra``
    carries the bytes the product needs."""
    indptr, indices, n = inputs
    numbers, ref_nnz = {}, None
    for ans in answers:
        got, ref_nnz = compare.compare_product(
            *ans, reference.product_blocks(indptr, indices, n, device), n, device)
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, 0), v)
    extra = {} if ref_nnz is None else {
        "bytes_needed": roofline.square_product_bytes(n, len(indices), ref_nnz)}
    return numbers, extra


def csr_of_blocks(blocks, n: int):
    """Host CSR ``(indptr, indices, shape)`` from the reference's
    ``(r0, r1, keys)`` blocks."""
    keys = torch.cat([k.cpu() for _, _, k in blocks]).numpy()
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(keys // n, minlength=n), out=indptr[1:])
    return indptr, (keys % n).astype(np.int32), (n, n)


def product_control(mix: dict, inputs, device) -> dict:
    """The products' control: the reference's C with its duplicates left in
    (every candidate kept: the merge skipped), judged as an answer."""
    indptr, indices, n = inputs
    blocks = reference.product_blocks(indptr, indices, n, device, dedup=False)
    return check_product([csr_of_blocks(blocks, n)], inputs, device)[0]


def load(root: Path, name: str) -> type[Op]:
    """The ``Op`` class of ``ops/<name>.py`` under ``root``'s benchmark."""
    from ..spec import HERE, _module

    if not _NAME.match(str(name)):
        raise ValueError(f"op name {name!r} is not a plain identifier")
    return _module(Path(root) / HERE / "ops" / f"{name}.py").Op


def make(root: Path, mix: dict, inputs, device: torch.device, mesh=None) -> Op:
    """The staged op a mix names, built on the generated ``inputs``."""
    return load(root, mix["op"])(mix, inputs, device, mesh)
