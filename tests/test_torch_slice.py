"""The slice as a whole: ``auto_executor`` and ``spgemm`` end to end against
the JAX package and scipy on every route (batched and unrolled ELL, blocked,
host, chunked ESC, giant rows), the import boundary, and the default
device."""
import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import ell as jx_ell

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import host as tp_host
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "binary_spgemm_tpu_torch"


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def assert_same(j, t):
    assert np.array_equal(j.indptr, t.indptr)
    assert np.array_equal(j.indices, t.indices)


def test_auto_executor_end_to_end():
    ja = jx.BCSR.random(1 << 16, 1 << 16, 2.0, seed=31)  # >= 2^16 rows: batched
    ta = to_port(ja)
    assert tp_ell.prefer_batched(ta, ta) and jx_ell.prefer_batched(ja, ja)
    jex = jx_ell.auto_executor(ja, ja)
    tex = tp.auto_executor(ta, ta, device="cpu")
    assert isinstance(tex, tp.EllSpGEMMExecutor) and tex.batched and jex.batched
    assert (tex.n_chunks, tex.sort_pad, tex.pads) == (
        jex.n_chunks, jex.sort_pad, jex.pads
    )
    c = tex.assemble(tex.run())
    assert_same(jex.assemble(jex.run()), c)
    assert c.equals(spgemm_oracle(ta, ta))


def test_spgemm_end_to_end():
    ja = jx.BCSR.random(1 << 16, 1 << 16, 6.5, seed=3)  # > HOST_MAX_FLOPS
    ta = to_port(ja)
    assert tp.spgemm_flops(ta, ta) > tp_host.HOST_MAX_FLOPS
    c = tp.spgemm(ta, ta, device="cpu")
    assert_same(jx.spgemm(ja, ja), c)
    assert c.equals(spgemm_oracle(ta, ta))
    # the staged executor is cached on operand identity and device
    ex = tp_ell.cached_executor(ta, ta, device="cpu")
    assert tp_ell.cached_executor(ta, ta, device="cpu") is ex


def test_spgemm_empty_operand():
    a = tp.BCSR(np.zeros(5, np.int32), np.zeros(0, np.int32), (4, 6))
    b = tp.BCSR.random(6, 3, 1.0, seed=1)
    c = tp.spgemm(a, b, device="cpu")
    assert c.shape == (4, 3) and c.nnz == 0
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.spgemm(b, b, device="cpu")


def test_host_route_raises():
    """Products of at most HOST_MAX_FLOPS flops are served by the host
    engine, as in the JAX package (they raised before it was ported)."""
    ja = jx.BCSR.random(500, 500, 2.0, seed=1)  # far below HOST_MAX_FLOPS
    a = to_port(ja)
    assert tp.spgemm_flops(a, a) <= tp_host.HOST_MAX_FLOPS
    c = tp.spgemm(a, a, device="cpu")
    assert_same(jx.spgemm(ja, ja), c)
    assert c.equals(spgemm_oracle(a, a))


def test_explicit_chunk_flops_raises(monkeypatch):
    """An explicit ``chunk_flops`` takes the chunked ESC engine in both
    packages (it raised before ESC was ported), even below
    ``HOST_MAX_FLOPS``; the host engine is not asked."""
    ja = jx.BCSR.random(500, 500, 2.0, seed=1)
    a = to_port(ja)
    monkeypatch.setattr(tp_host, "host_spgemm", None)  # must not be reached
    for chunk_flops in (1 << 20, 300):
        c = tp.spgemm(a, a, chunk_flops=chunk_flops, device="cpu")
        assert_same(jx.spgemm(ja, ja, chunk_flops=chunk_flops), c)
        assert c.equals(spgemm_oracle(a, a))


def giant_cases():
    """``tests/test_spgemm.py``'s giant-row cases: rows 3 and 107 past the
    budget (300 flops), a B row longer than the budget (100 flops, the
    one-entry window), and giant rows at the matrix's first and last row."""
    rng = np.random.default_rng(0)
    a = jx.BCSR.random(200, 200, 2.0, seed=1)
    rows, cols = a.to_coo()
    extra_r = np.concatenate([np.full(150, 3), np.full(180, 107)])
    extra_c = rng.integers(0, 200, size=330)
    a2 = jx.BCSR.from_coo(np.concatenate([rows, extra_r]),
                          np.concatenate([cols, extra_c]), (200, 200)).sum_duplicates()
    b_rows = np.concatenate([np.zeros(400, np.int64), np.arange(200)])
    b_cols = np.concatenate([rng.integers(0, 200, 400), np.arange(200)])
    b = jx.BCSR.from_coo(b_rows, b_cols, (200, 200)).sum_duplicates()
    a3 = jx.BCSR.from_coo(
        np.concatenate([np.zeros(160, np.int64), np.full(160, 199)]),
        np.concatenate([rng.integers(0, 200, 160), rng.integers(0, 200, 160)]),
        (200, 200),
    ).sum_duplicates()
    return [(a2, a2, 300), (a2, b, 100), (a3, b, 100)]


@pytest.mark.parametrize("chunk_flops", [None, 512])
def test_giant_rows_raise(monkeypatch, chunk_flops):
    """Rows past ``GIANT_ROW_FLOPS`` take the column-windowed route, equal
    to the JAX package's and scipy (they raised before it was ported);
    with ``chunk_flops`` the windows and the rest go through ESC."""
    from binary_spgemm_tpu.ops import spgemm as jx_sp

    for ja, jb, budget in giant_cases():
        monkeypatch.setattr(jx_sp, "GIANT_ROW_FLOPS", budget)
        monkeypatch.setattr(tp_sp, "GIANT_ROW_FLOPS", budget)
        a, b = to_port(ja), to_port(jb)
        rf = tp_sp.row_flops(a, b)
        assert (rf > budget).sum() >= 2
        c = tp.spgemm(a, b, chunk_flops=chunk_flops, device="cpu")
        assert_same(jx.spgemm(ja, jb, chunk_flops=chunk_flops), c)
        assert c.equals(spgemm_oracle(a, b))


def test_blocked_route_raises():
    """The blocked route now serves block-clustered products where the JAX
    package takes its blocked engine; what still raises is what the JAX
    package rejects too (mismatched shapes)."""
    jb = jx.BCSR.random_blocked(4096, 128, 2.0, 0.3, seed=2)
    from binary_spgemm_tpu.ops.bsr import BsrStagedExecutor as JxStaged
    from binary_spgemm_tpu.ops.bsr import maybe_bsr_executor as jx_screen
    from binary_spgemm_tpu_torch.ops.bsr import BsrStagedExecutor

    assert isinstance(jx_screen(jb, jb), JxStaged)  # the JAX blocked route
    b = to_port(jb)
    ex = tp.auto_executor(b, b, device="cpu")
    assert isinstance(ex, BsrStagedExecutor)
    ref = jx_ell.auto_executor(jb, jb)
    c = ex.assemble(ex.run())
    assert_same(ref.assemble(ref.run()), c)
    assert c.equals(spgemm_oracle(b, b))
    c1 = tp.spgemm(b, b, device="cpu")
    assert_same(jx.spgemm(jb, jb), c1)
    assert c1.equals(c)
    rect = tp.BCSR.random(2048, 4096, 2.0, seed=1)
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.spgemm(b, rect, device="cpu")
    blk, blk_rect = tp.BlockedBCSR.from_bcsr(b), tp.BlockedBCSR.from_bcsr(rect)
    with pytest.raises(ValueError, match="block shape mismatch"):
        tp.bsr_spgemm(blk, blk_rect, device="cpu")
    from binary_spgemm_tpu.ops.bsr import block_clustering_ratio as jx_ratio
    from binary_spgemm_tpu_torch.ops.bsr import block_clustering_ratio

    assert block_clustering_ratio(b) == jx_ratio(jb)


def test_unrolled_routes_raise(monkeypatch):
    """Below 2^16 rows, and past the skew guard, both packages take the
    unrolled plan; the port now serves it, equal to the JAX package."""
    ja = jx.BCSR.random(3000, 3000, 4.0, seed=1)  # few rows: unrolled plan
    a = to_port(ja)
    assert not tp_ell.prefer_batched(a, a)
    ref = spgemm_oracle(a, a)

    def same_unrolled(jex, tex):
        assert not tex.batched and not jex.batched
        assert (tex.n_chunks, tex.sort_pad, tex.pads, tex.chunks) == (
            jex.n_chunks, jex.sort_pad, jex.pads, jex.chunks
        )
        c = tex.assemble(tex.run())
        assert_same(jex.assemble(jex.run()), c)
        assert c.equals(ref)

    same_unrolled(jx_ell.auto_executor(ja, ja), tp.auto_executor(a, a, device="cpu"))
    # the skew guard sends both packages to the unrolled plan too
    for mod in (tp_ell, jx_ell):
        monkeypatch.setattr(mod, "prefer_batched", lambda a, b: True)
        monkeypatch.setattr(mod, "BATCHED_MAX_SLOTS", 1)
    same_unrolled(jx_ell.auto_executor(ja, ja), tp.auto_executor(a, a, device="cpu"))


def test_past_the_resident_budget_raises(monkeypatch):
    """Past ``AUTO_ELL_MAX_SLOTS`` both packages take the chunked ESC engine
    (it raised before ESC was ported): ``auto_executor`` returns a
    ``SpGEMMExecutor`` with the JAX package's plan, and ``spgemm`` the
    same product."""
    ja = jx.BCSR.random(3000, 3000, 4.0, seed=1)
    a = to_port(ja)
    for mod in (tp_ell, jx_ell):
        monkeypatch.setattr(mod, "prefer_batched", lambda a, b: True)
        monkeypatch.setattr(mod, "AUTO_ELL_MAX_SLOTS", 0)
    ex = tp.auto_executor(a, a, device="cpu")
    jex = jx_ell.auto_executor(ja, ja)
    assert isinstance(ex, tp.SpGEMMExecutor) and isinstance(jex, jx.SpGEMMExecutor)
    assert (ex.chunks, ex.flops_pad) == (jex.chunks, jex.flops_pad)
    c = ex.assemble(ex.run())
    assert_same(jex.assemble(jex.run()), c)
    assert c.equals(spgemm_oracle(a, a))
    tp_ell._EXEC_CACHE.clear()
    assert_same(jx.spgemm(ja, ja), tp.spgemm(a, a, device="cpu"))


def heavy_row_product():
    """ROADMAP's heavy-row product: a random 2^16 pattern whose row 0 gets
    12,000 more columns.  Both packages plan it batched with k = 64 and
    sort_pad 172,032, past K1's longest row."""
    n = 65536
    a = jx.BCSR.random(n, n, 4.0, seed=1)
    r, c = a.to_coo()
    cols = np.random.default_rng(0).choice(n, 12000, replace=False)
    rows = np.concatenate([r, np.zeros(12000, np.int64)])
    return jx.BCSR.from_coo(rows, np.concatenate([c, cols]), (n, n))


def test_heavy_row_product_sorts_past_the_kernels_window():
    from binary_spgemm_tpu_torch.ops import bitonic

    ja = heavy_row_product()
    ta = to_port(ja)
    jex = jx_ell.auto_executor(ja, ja)
    tex = tp.auto_executor(ta, ta, device="cpu")
    assert tex.batched and (tex.n_chunks, tex.sort_pad) == (64, 172032)
    assert (tex.n_chunks, tex.sort_pad, tex.pads) == (jex.n_chunks, jex.sort_pad, jex.pads)
    before = dict(bitonic.sort_rows.routes)
    c = tex.assemble(tex.run())
    assert bitonic.sort_rows.routes["torch_sort"] == before["torch_sort"] + 2 * tex.n_groups
    assert bitonic.sort_rows.routes["k1"] == before["k1"]
    assert c.nnz == 1_130_438
    assert_same(jex.assemble(jex.run()), c)
    assert c.equals(spgemm_oracle(ta, ta))


def test_unrolled_executor_runs_without_jax():
    """The port imports and runs the unrolled executor in a process where
    importing jax fails."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "import binary_spgemm_tpu_torch as tp\n"
        "from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle\n"
        "a = tp.BCSR.random(800, 800, 5.0, seed=3)\n"
        "ex = tp.EllSpGEMMExecutor(a, a, row_chunks='deal', device='cpu')\n"
        "assert not ex.batched and ex.row_sets is not None\n"
        "assert ex.assemble(ex.run()).equals(spgemm_oracle(a, a))\n"
        "assert tp.spgemm(a, a, device='cpu').equals(spgemm_oracle(a, a))\n"
        "assert not any(m == 'binary_spgemm_tpu' or m.startswith('binary_spgemm_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def port_sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 10
    assert PORT / "parallel" / "dist_spgemm.py" in files
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = ("jax", "jaxlib", "binary_spgemm_tpu")
    for path in port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path}: imports {name}"


def test_entry_points_default_to_cuda():
    from binary_spgemm_tpu_torch.ops import bsr as tp_bsr
    from binary_spgemm_tpu_torch.parallel import dist_spgemm as tp_dist
    from binary_spgemm_tpu_torch.parallel import dryrun as tp_dryrun
    from binary_spgemm_tpu_torch.parallel import launch as tp_launch
    from binary_spgemm_tpu_torch.parallel import mesh as tp_mesh
    from binary_spgemm_tpu_torch.parallel import multihost as tp_mh

    dist_entries = (tp_dist.dist_spgemm, tp_dist.dist_masked_spgemm,
                    tp_dist.dist_spgemm_or, tp_dist.dist_spm_or, tp_mesh.make_row_mesh,
                    tp_mh.dist_spgemm_from_local, tp_mh.global_row_mesh,
                    tp_launch.launch, tp_dryrun.dryrun_multichip)
    for fn in (tp.spgemm, tp.auto_executor, tp.EllSpGEMMExecutor,
               tp.ell_spgemm, tp_ell.cached_executor, tp.bsr_spgemm, tp_bsr.BsrExecutor,
               tp_bsr.BsrStagedExecutor, tp_bsr.maybe_bsr_executor,
               tp_sp.blocked_route, tp.SpGEMMExecutor, tp.tuned_executor,
               *dist_entries):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # the backend follows from the rank count and the device: no knob
    assert "backend" not in inspect.signature(tp_launch.launch).parameters
    d = tp.BCSR.random(64, 64, 2.0, seed=4)
    if torch.cuda.is_available():
        assert tp_mesh.make_row_mesh().device.type == "cuda"
    else:  # no quiet switch to the CPU
        for build in (tp_mesh.make_row_mesh, lambda: tp_dist.dist_spgemm(d, d),
                      lambda: tp_dist.dist_masked_spgemm(d, d, d),
                      lambda: tp_dist.dist_spgemm_or(d, d, d),
                      lambda: tp_dist.dist_spm_or(d, d),
                      lambda: tp_mh.dist_spgemm_from_local(d, [0, 64], d),
                      lambda: tp_launch.launch(tp_dryrun.dryrun_paths, 2),
                      lambda: tp_dryrun.dryrun_multichip(2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
    a = tp.BCSR.random(1 << 16, 1 << 16, 1.0, seed=1)
    blk = tp.BlockedBCSR.from_bcsr(tp.BCSR.random_blocked(512, 128, 1.5, 0.2, seed=8))
    if torch.cuda.is_available():
        ex = tp.EllSpGEMMExecutor(a, a, batched=True)
        assert ex.er_all.device.type == "cuda"
        assert tp_bsr.BsrExecutor(blk, blk).a_dev.device.type == "cuda"
        assert tp.SpGEMMExecutor(a, a).a_idx.device.type == "cuda"
        assert tp.tuned_executor(a, a, top=1, times=1).er_all.device.type == "cuda"
    else:  # no quiet switch to the CPU
        for build in (lambda: tp.EllSpGEMMExecutor(a, a, batched=True),
                      lambda: tp.SpGEMMExecutor(a, a),
                      lambda: tp.tuned_executor(a, a),
                      lambda: tp.auto_executor(a, a, chunk_flops=1 << 20),
                      lambda: tp.spgemm(a, a, chunk_flops=1 << 20)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp_bsr.BsrExecutor(blk, blk)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.bsr_spgemm(blk, blk)
        b = tp.BCSR.random_blocked(4096, 128, 2.0, 0.3, seed=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.auto_executor(b, b)


def test_op_family_end_to_end():
    """The op family at 2^16 rows through its one-shot entry points (the
    batched ``masked=True`` and plain plans the routers pick) and the
    one-sort step: each product equal to the JAX package's and scipy's."""
    ja = jx.BCSR.random(1 << 16, 1 << 16, 6.5, seed=3)
    ta = to_port(ja)
    sa = ta.to_scipy()
    prod = sa @ sa

    def csr(m):
        m = m.tocsr()
        m.eliminate_zeros()
        m.sort_indices()
        return tp.BCSR(m.indptr, m.indices, m.shape)

    c = tp.masked_spgemm(ta, ta, ta, device="cpu")
    assert_same(jx.masked_spgemm(ja, ja, ja), c)
    assert c.equals(csr(prod.multiply(sa)))
    c = tp.spgemm_or(ta, ta, ta, device="cpu")
    assert_same(jx.spgemm_or(ja, ja, ja), c)
    assert c.equals(csr(sa + prod))
    c = tp.spgemm_or(ta, ta, ta, mask=ta, device="cpu")
    assert_same(jx.spgemm_or(ja, ja, ja, mask=ja), c)
    assert c.equals(ta.sum_duplicates())  # D ∪ (A ∩ A·A) = A
    jc = jx.BCSR.random(1 << 16, 1 << 16, 3.0, seed=4)
    c = tp.spm_or(ta, to_port(jc), device="cpu")
    assert_same(jx.spm_or(ja, jc), c)
    assert c.equals(csr(sa + to_port(jc).to_scipy()))
    for masked in (False, True):
        jex = jx_ell.cached_executor(ja, ja, masked=masked)
        tex = tp_ell.cached_executor(ta, ta, masked=masked, device="cpu")
        assert tex.batched and (tex.n_chunks, tex.sort_pad) == (jex.n_chunks, jex.sort_pad)
        c = tex.assemble_padded(tex.run_padded())
        assert_same(jex.assemble_padded(jex.run_padded()), c)
        assert c.equals(csr(prod))


def test_op_family_defaults_to_cuda():
    """The op family's entry points run on the card unless told otherwise:
    past the host routes they raise here, with no quiet switch to the
    CPU; products the host routes take need no card."""
    from binary_spgemm_tpu_torch.ops import fused, masked, union

    for fn in (tp.masked_spgemm, tp.spm_or, tp.spgemm_or):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert fused.spgemm_or is tp.spgemm_or and masked.masked_spgemm is tp.masked_spgemm
    assert union.spm_or is tp.spm_or
    small = tp.BCSR.random(300, 300, 2.0, seed=1)
    assert tp.masked_spgemm(small, small, small).equals(
        tp.masked_spgemm(small, small, small, device="cpu"))
    assert tp.spgemm_or(small, small, small).equals(
        tp.spgemm_or(small, small, small, device="cpu"))
    assert tp.spm_or(small, small).equals(small.sum_duplicates())
    if torch.cuda.is_available():
        return
    a = tp.BCSR.random(20000, 20000, 12.0, seed=2)
    for run in (lambda: tp.masked_spgemm(a, a, a), lambda: tp.spgemm_or(a, a, a),
                lambda: tp.spgemm_or(a, a, a, mask=a), lambda: tp.spm_or(a, a),
                lambda: tp.masked_spgemm(a, a, a, chunk_flops=1 << 20),
                lambda: tp.spgemm_or(a, a, a, chunk_flops=1 << 20),
                lambda: tp.tuned_executor(a, a, masked=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
