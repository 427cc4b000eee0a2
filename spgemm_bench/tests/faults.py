"""Faults planted in the program under a run, for the test that sees
``correct`` come out false.  Each is a module-level function (spawned ranks
import it) that monkeypatches the program in the process that calls it."""
import torch

_ORIGINALS = []


def _set(owner, name, value):
    _ORIGINALS.append((owner, name, getattr(owner, name)))
    setattr(owner, name, value)


def undo():
    """Put back everything the faults replaced in this process."""
    while _ORIGINALS:
        owner, name, value = _ORIGINALS.pop()
        setattr(owner, name, value)


def _wrap(owner, name, fix):
    orig = getattr(owner, name)

    def patched(*args, **kwargs):
        return fix(args, orig(*args, **kwargs))

    _set(owner, name, patched)


def _alter_first_column(idx, nnz, n_cols):
    """The first produced column of the first non-empty row moved by one."""
    idx = idx.clone()
    row = int(torch.nonzero(nnz > 0)[0])
    live = torch.nonzero(idx[row, : int(nnz[row])] < n_cols)
    j = int(live[0])
    idx[row, j] = (idx[row, j] + 1) % n_cols
    return idx


def _executors():
    from binary_spgemm_tpu_torch.ops.ell import EllSpGEMMExecutor
    from binary_spgemm_tpu_torch.ops.spgemm import SpGEMMExecutor

    return ((EllSpGEMMExecutor, lambda ex: ex.rows_pad),
            (SpGEMMExecutor, lambda ex: ex._rows_pad))


def product_answer_altered():
    for cls, _ in _executors():
        _wrap(cls, "run", lambda a, out: (
            _alter_first_column(out[0], out[1], a[0].n_cols), out[1]))


def product_half_left_out():
    """The second half of the chunks' streams replaced by empty rows (their
    separators alone): half the rows' work left out."""
    def fix(args, out, rows_pad):
        idx, nnz = out[0].clone(), out[1].clone()
        half = idx.shape[0] // 2
        idx[half:, :rows_pad] = args[0].n_cols
        nnz[half:] = rows_pad
        return idx, nnz

    for cls, rows_pad in _executors():
        _wrap(cls, "run", lambda a, out, rp=rows_pad: fix(a, out, rp(a[0])))


def triangles_answer_altered():
    from binary_spgemm_tpu_torch.ops.ell import EllSpGEMMExecutor

    def fix(args, sums):
        sums = sums.clone()
        sums[0] += 6  # one triangle more
        return sums

    _wrap(EllSpGEMMExecutor, "run_counts_sum", fix)


def triangles_half_left_out():
    from binary_spgemm_tpu_torch.ops.ell import EllSpGEMMExecutor

    def fix(args, sums):
        sums = sums.clone()
        sums[sums.shape[0] // 2 :] = 0
        return sums

    _wrap(EllSpGEMMExecutor, "run_counts_sum", fix)


def dist_answer_altered():
    from binary_spgemm_tpu_torch.parallel import dist_spgemm as ds

    def fix(args, step):
        step.c_idx = step.c_idx.clone()
        row = int(torch.nonzero(step.nnz > 0)[0])
        step.c_idx[row, 0] = step.c_idx[row, 0] + 1
        return step

    _wrap(ds, "dist_spgemm_ell", fix)


def dist_half_left_out():
    """Every rank's second half of its sub-chunks computed as empty."""
    from binary_spgemm_tpu_torch.parallel import dist_spgemm as ds

    def fix(args, out):
        ptr, idx, nnz = (t.clone() for t in out)
        half = ptr.shape[0] // 2
        ptr[half:] = 0
        nnz[half:] = 0
        return ptr, idx, nnz

    _wrap(ds, "sort_compress_2d_keys", fix)
    _wrap(ds, "sort_compress_2d", fix)


def dist_exchange_left_out():
    """B's class tables never gathered: each rank sees its own slice and
    zeros where the other ranks' would be."""
    from binary_spgemm_tpu_torch.parallel import dist_spgemm as ds

    def local_only(tables_sh, mesh):
        flat = ds._flat_tables(tables_sh)
        g = torch.zeros((mesh.size, flat.numel()), dtype=flat.dtype, device=flat.device)
        g[mesh.rank] = flat
        out, off = [], 0
        for t in tables_sh:
            r, w = t.shape
            out.append(g[:, off : off + r * w].reshape(-1, w).contiguous())
            off += r * w
        return out

    _set(ds, "_gather_tables", local_only)
