"""The bytes a boolean product C = A·A needs, whatever computes it.

A read once, C's column indices and row pointers written once: int32
indices, row pointers int32 until the entry count passes 2^31 - 1 and int64
past it (the program's CSR contract).  No operation bound: a product's
integer operations depend on the algorithm, and a later route that does
fewer of them must not read over 100 %.
"""
from __future__ import annotations

__all__ = ["csr_bytes", "square_product_bytes"]

INT32_MAX = (1 << 31) - 1


def csr_bytes(n_rows: int, nnz: int) -> int:
    ptr = 4 if nnz <= INT32_MAX else 8
    return (n_rows + 1) * ptr + nnz * 4


def square_product_bytes(n: int, nnz_a: int, nnz_c: int) -> int:
    """Bytes read and written by C = A·A at the least."""
    return csr_bytes(n, nnz_a) + csr_bytes(n, nnz_c)
