"""The comparison that decides ``correct``.

Every number compared is exact, so every limit is 0:

* ``rows_wrong``: rows of the program's C whose columns are not exactly the
  reference's row (missing, extra, duplicated or out of order);
* ``nnz_gap``: |nnz of the program's C - nnz of the reference's|;
* ``count_gap``: the largest |answer - reference| over the answers checked
  (the triangle counts of every timed call).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LIMITS", "compare_counts", "compare_product", "judge"]

LIMITS = {"rows_wrong": 0, "nnz_gap": 0, "count_gap": 0}


def _bad_rows(p_keys, r_keys, n: int) -> torch.Tensor:
    """Rows (as ``key // n``) where two key streams disagree, or where the
    program's stream is not strictly ascending."""
    bad = [r_keys[~torch.isin(r_keys, p_keys)], p_keys[~torch.isin(p_keys, r_keys)]]
    if p_keys.numel() > 1:
        step = p_keys[1:] <= p_keys[:-1]
        bad.append(p_keys[1:][step])
    return torch.unique(torch.cat(bad) // n)


def compare_product(indptr, indices, shape, ref_blocks, n: int, device):
    """Compare the program's host CSR ``(indptr, indices, shape)`` with the
    reference's ``(r0, r1, sorted keys)`` blocks of A·A; returns the numbers
    and the reference's entry count."""
    indptr = np.asarray(indptr, np.int64)
    if tuple(shape) != (n, n) or indptr.shape != (n + 1,) or indptr[-1] != len(indices):
        ref_nnz = sum(int(k.numel()) for _, _, k in ref_blocks)
        return {"rows_wrong": n, "nnz_gap": abs(len(indices) - ref_nnz)}, ref_nnz
    rows_wrong = 0
    ref_nnz = 0
    for r0, r1, r_keys in ref_blocks:
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        lens = torch.from_numpy(np.diff(indptr[r0 : r1 + 1])).to(device)
        rows = torch.repeat_interleave(
            torch.arange(r0, r1, device=device, dtype=torch.int64), lens)
        cols = torch.from_numpy(np.asarray(indices[e0:e1]).astype(np.int64)).to(device)
        p_keys = rows * n + cols
        ref_nnz += int(r_keys.numel())
        if p_keys.numel() == r_keys.numel() and torch.equal(p_keys, r_keys):
            continue
        rows_wrong += int(_bad_rows(p_keys, r_keys, n).numel())
    return {"rows_wrong": rows_wrong, "nnz_gap": abs(int(indptr[-1]) - ref_nnz)}, ref_nnz


def compare_counts(answers, reference: int) -> dict:
    """``count_gap`` of the answers against the reference's count."""
    if not answers:
        return {"count_gap": None}
    return {"count_gap": max(abs(int(a) - int(reference)) for a in answers)}


def judge(numbers: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    is present and within its limit."""
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    ok = bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
