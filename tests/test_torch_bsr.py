"""The blocked route of the port against the JAX package and scipy on the CPU:
the generators, ``BlockedBCSR``, the pair plan, K3's plain version against
the Pallas kernel (interpreted), ``bsr_spgemm`` on both backends, the staged
executors, and the routing through ``auto_executor``, ``cached_executor``,
``spgemm`` and ``blocked_route``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.formats.bbcsr import BlockedBCSR as JBlocked
from binary_spgemm_tpu.ops import bsr as jx_bsr
from binary_spgemm_tpu.ops import ell as jx_ell
from binary_spgemm_tpu.ops import spgemm as jx_sp
from binary_spgemm_tpu.ops.pallas_bsr import grouped_block_matmul as jx_k3
from binary_spgemm_tpu.utils import oracle as jx_oracle

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import block_matmul as k3
from binary_spgemm_tpu_torch.ops import bsr as tp_bsr
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp
from binary_spgemm_tpu_torch.utils import oracle as tp_oracle

CPU = "cpu"


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def to_port_blocked(m):
    return tp.blocked_from_arrays(
        m.structure.indptr, m.structure.indices, m.blocks, m.block_size, m.shape
    )


def same(j, t):
    return (
        tuple(j.shape) == tuple(t.shape)
        and np.array_equal(j.indptr, t.indptr)
        and np.array_equal(j.indices, t.indices)
    )


def same_blocked(j, t):
    return (
        same(j.structure, t.structure)
        and j.block_size == t.block_size
        and tuple(j.shape) == tuple(t.shape)
        and np.array_equal(j.blocks, t.blocks)
    )


def blocked_coo(n, b, nblocks_per_row, seed, block_density=0.3):
    """COO of a random block-clustered n x n pattern (duplicates kept)."""
    rng = np.random.default_rng(seed)
    nb = n // b
    rows, cols = [], []
    for i in range(nb):
        for j in rng.choice(nb, size=min(nblocks_per_row, nb), replace=False):
            k = max(1, int(block_density * b * b))
            rows.append(i * b + rng.integers(0, b, k))
            cols.append(j * b + rng.integers(0, b, k))
    return np.concatenate(rows), np.concatenate(cols)


def blocked_pair(n, b, nblocks_per_row, seed, block_density=0.3):
    """The same block-clustered matrix in both packages, canonical."""
    r, c = blocked_coo(n, b, nblocks_per_row, seed, block_density)
    j = jx.BCSR.from_coo(r, c, (n, n)).sum_duplicates()
    t = tp.BCSR.from_coo(r, c, (n, n)).sum_duplicates()
    assert same(j, t)
    return j, t


# -- generators and formats ---------------------------------------------------


@pytest.mark.parametrize(
    "args",
    [(4096, 128, 2.0, 0.3, 3), (1000, 64, 1.5, 0.2, 1), (300, 100, 2.0, 0.5, 2),
     (64, 128, 0.0, 0.3, 4)],
)
def test_random_blocked_matches_jax(args):
    n, block, bpr, dens, seed = args
    assert same(
        jx.BCSR.random_blocked(n, block, bpr, dens, seed=seed),
        tp.BCSR.random_blocked(n, block, bpr, dens, seed=seed),
    )


@pytest.mark.parametrize(
    "n,d,bw,seed,diag", [(3000, 4.0, 16, 1, True), (500, 2.5, 3, 2, False)]
)
def test_banded_matches_jax(n, d, bw, seed, diag):
    assert same(
        jx.BCSR.banded(n, d, bw, seed=seed, diagonal=diag),
        tp.BCSR.banded(n, d, bw, seed=seed, diagonal=diag),
    )


@pytest.mark.parametrize("scale,ef,seed,sym", [(10, 8.0, 1, False), (9, 4.0, 2, True)])
def test_rmat_matches_jax(scale, ef, seed, sym):
    assert same(
        jx.BCSR.rmat(scale, ef, seed=seed, symmetric=sym),
        tp.BCSR.rmat(scale, ef, seed=seed, symmetric=sym),
    )


def test_dense_round_trip_and_sum_duplicates_match_jax():
    rng = np.random.default_rng(5)
    dense = rng.random((37, 23)) < 0.2
    j, t = jx.BCSR.from_dense(dense), tp.BCSR.from_dense(dense)
    assert same(j, t)
    assert np.array_equal(t.to_dense(), dense)
    r, c = rng.integers(0, 37, 400), rng.integers(0, 23, 400)
    jd = jx.BCSR.from_coo(r, c, (37, 23))
    td = tp.BCSR.from_coo(r, c, (37, 23))
    assert not td.is_canonical()
    assert same(jd.sum_duplicates(), td.sum_duplicates())
    assert td.sum_duplicates().is_canonical()
    canon = td.sum_duplicates()
    assert canon.sum_duplicates() is canon


def test_masked_oracle_matches_jax():
    jf, tf = blocked_pair(256, 64, 3, seed=21)
    ja, ta = blocked_pair(256, 64, 2, seed=20)
    assert same(
        jx_oracle.masked_spgemm_oracle(jf, ja, ja),
        tp_oracle.masked_spgemm_oracle(tf, ta, ta),
    )


@pytest.mark.parametrize(
    "case", ["square", "ragged", "empty", "b128"]
)
def test_blocked_format_matches_jax(case):
    if case == "square":
        j, t = blocked_pair(256, 64, 2, seed=1)
        b = 64
    elif case == "ragged":  # element shape not a multiple of the block size
        j = jx.BCSR.random(100, 70, 3.0, seed=2).sum_duplicates()
        t = tp.BCSR.random(100, 70, 3.0, seed=2).sum_duplicates()
        b = 32
    elif case == "empty":
        j = jx.BCSR.from_dense(np.zeros((64, 64)))
        t = tp.BCSR.from_dense(np.zeros((64, 64)))
        b = 32
    else:
        j = jx.BCSR.random_blocked(512, 128, 1.5, 0.2, seed=8)
        t = to_port(j)
        b = 128
    jb, tb = JBlocked.from_bcsr(j, b), tp.BlockedBCSR.from_bcsr(t, b)
    assert same_blocked(jb, tb)
    assert tb.to_bcsr().equals(t) and same(jb.to_bcsr(), tb.to_bcsr())
    assert (tb.n_blocks, tb.nnz) == (jb.n_blocks, jb.nnz) and tb.nnz == t.nnz
    assert tb.block_occupancy() == jb.block_occupancy()
    assert repr(tb) == repr(jb)
    # a JAX blocked matrix carried across is the same matrix, not shared
    carried = to_port_blocked(jb)
    assert same_blocked(jb, carried)
    assert not np.shares_memory(carried.blocks, jb.blocks)


def test_blocked_from_arrays_checks_tiles():
    j = JBlocked.from_bcsr(jx.BCSR.random_blocked(512, 128, 1.5, 0.2, seed=8), 128)
    with pytest.raises(ValueError, match="blocks shape"):
        tp.blocked_from_arrays(
            j.structure.indptr, j.structure.indices, j.blocks[1:], 128, j.shape
        )


# -- the pair plan ------------------------------------------------------------


@pytest.mark.parametrize(
    "case", ["square64", "chunked32", "rect32", "b128", "empty"]
)
def test_block_pairs_and_pad_plan_match_jax(case):
    if case == "square64":
        (ja, ta), b = blocked_pair(256, 64, 2, seed=3), 64
        jb_, tb_ = ja, ta
    elif case == "chunked32":
        (ja, ta), b = blocked_pair(512, 32, 6, seed=7, block_density=0.1), 32
        jb_, tb_ = ja, ta
    elif case == "rect32":
        ja = jx.BCSR.random(96, 64, 4.0, seed=5).sum_duplicates()
        jb_ = jx.BCSR.random(64, 128, 4.0, seed=6).sum_duplicates()
        ta, tb_, b = to_port(ja), to_port(jb_), 32
    elif case == "b128":
        ja = jx.BCSR.random_blocked(4096, 128, 2.0, 0.3, seed=3)
        ta, jb_, tb_, b = to_port(ja), ja, to_port(ja), 128
    else:
        ja = jx.BCSR.from_dense(np.zeros((64, 64)))
        ta, jb_, tb_, b = to_port(ja), ja, to_port(ja), 32
    jp = jx_bsr.block_pairs(JBlocked.from_bcsr(ja, b), JBlocked.from_bcsr(jb_, b))
    tpl = tp_bsr.block_pairs(
        tp.BlockedBCSR.from_bcsr(ta, b), tp.BlockedBCSR.from_bcsr(tb_, b)
    )
    for x, y in zip(jp, tpl):
        assert np.array_equal(x, y)
    n_out = len(jp[3])
    for x, y in zip(
        jx_bsr._pad_pair_plan(jp[0], jp[1], jp[2], n_out),
        tp_bsr._pad_pair_plan(tpl[0], tpl[1], tpl[2], n_out),
    ):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_pad_plan_without_tail():
    # 64 pairs is already a bucket size: no padded tail, so the scratch
    # block is visited by no pair
    seg = np.repeat(np.arange(16), 4)
    ka = np.arange(64) % 5
    kb = np.arange(64) % 7
    seg_p, ka_p, kb_p, first = tp_bsr._pad_pair_plan(ka, kb, seg, 16)
    assert len(seg_p) == 64 and not (seg_p == 16).any()
    for x, y in zip(
        jx_bsr._pad_pair_plan(ka, kb, seg, 16), (seg_p, ka_p, kb_p, first)
    ):
        assert np.array_equal(x, y)


# -- K3 -----------------------------------------------------------------------


def k3_case(b, n_a, n_b, group_sizes, seed, density=0.3, ones=False):
    """A random sorted pair plan over random 0/1 tiles (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    shape_a, shape_b = (n_a, b, b), (n_b, b, b)
    if ones:
        ta, tb = np.ones(shape_a, np.uint8), np.ones(shape_b, np.uint8)
    else:
        ta = (rng.random(shape_a) < density).astype(np.uint8)
        tb = (rng.random(shape_b) < density).astype(np.uint8)
    seg = np.repeat(np.arange(len(group_sizes)), group_sizes)
    ka = rng.integers(0, n_a, len(seg))
    kb = rng.integers(0, n_b, len(seg))
    return ta, tb, tp_bsr._pad_pair_plan(ka, kb, seg, len(group_sizes))


def run_both_k3(ta, tb, plan, n_out):
    seg, ka, kb, first = plan
    jgot = np.asarray(
        jx_k3(
            *(jnp.asarray(x) for x in (seg, ka, kb, first)),
            jnp.asarray(ta, jnp.bfloat16),
            jnp.asarray(tb, jnp.bfloat16),
            n_out=n_out, interpret=True,
        )
    )
    tt = [torch.from_numpy(x) for x in (seg, ka, kb, first)]
    a_t = torch.from_numpy(ta).to(torch.bfloat16)
    b_t = torch.from_numpy(tb).to(torch.bfloat16)
    plain = k3.grouped_block_matmul_plain(*tt, a_t, b_t, n_out=n_out)
    return jgot, plain, tt, a_t, b_t


@pytest.mark.parametrize(
    "b,group_sizes,ones",
    [(32, [1, 3, 2, 5, 1], False), (64, [2, 1, 4], False), (128, [1, 2, 3], False),
     (32, [7, 2], True), (100, [2, 3], False), (16, [3, 1, 2], False),
     (128, [40, 1], False)],
)
def test_k3_plain_matches_the_pallas_kernel(b, group_sizes, ones):
    ta, tb, plan = k3_case(b, 6, 5, group_sizes, seed=b + len(group_sizes), ones=ones)
    n_real = len(group_sizes)
    jgot, plain, tt, a_t, b_t = run_both_k3(ta, tb, plan, n_real + 1)
    # integer counts in f32: exactly equal on the blocks pairs visit
    assert np.array_equal(jgot[:n_real], plain[:n_real].numpy())
    # the wrapper on CPU tensors is the plain version, and counts no launch
    before = k3.grouped_block_matmul.launches
    got = k3.grouped_block_matmul(*tt, a_t, b_t, n_out=n_real + 1)
    assert torch.equal(got, plain)
    assert k3.grouped_block_matmul.launches == before
    # the product against numpy in int64
    seg, ka, kb, _ = plan
    want = np.zeros((n_real + 1, b, b), np.int64)
    for s, i, j in zip(seg, ka, kb):
        want[s] += ta[i].astype(np.int64) @ tb[j].astype(np.int64)
    assert np.array_equal(plain.numpy(), want)


def test_k3_plain_blocks_no_pair_visits_are_zero():
    ta, tb, _ = k3_case(32, 3, 3, [1], seed=1)
    seg = torch.tensor([0, 0, 2, 9], dtype=torch.int32)  # 1 and 3 unvisited; 9 past n_out
    ka = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    kb = torch.tensor([1, 2, 0, 0], dtype=torch.int32)
    first = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    a_t = torch.from_numpy(ta).to(torch.bfloat16)
    b_t = torch.from_numpy(tb).to(torch.bfloat16)
    out = k3.grouped_block_matmul(seg, ka, kb, first, a_t, b_t, n_out=4)
    assert out.shape == (4, 32, 32)
    assert not out[1].any() and not out[3].any()
    want0 = ta[0].astype(np.int64) @ tb[1] + ta[1].astype(np.int64) @ tb[2]
    assert np.array_equal(out[0].numpy(), want0)
    # a pair with an out-of-range tile index contributes nothing
    ka_bad = torch.tensor([0, 7, 2, 0], dtype=torch.int32)
    out_bad = k3.grouped_block_matmul(seg, ka_bad, kb, first, a_t, b_t, n_out=4)
    assert np.array_equal(out_bad[0].numpy(), ta[0].astype(np.int64) @ tb[1])


def test_k3_argument_checks():
    z = torch.zeros(4, dtype=torch.int32)
    t = torch.zeros((2, 32, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        k3.grouped_block_matmul(z.long(), z, z, z, t, t, n_out=1)
    with pytest.raises(ValueError, match="pairs"):
        k3.grouped_block_matmul(z, z[:3], z, z, t, t, n_out=1)
    with pytest.raises(ValueError, match="bf16"):
        k3.grouped_block_matmul(z, z, z, z, t.float(), t, n_out=1)
    with pytest.raises(ValueError, match="bf16"):
        k3.grouped_block_matmul(z, z, z, z, t.transpose(1, 2), t, n_out=1)
    with pytest.raises(ValueError, match="tile sides"):
        k3.grouped_block_matmul(z, z, z, z, t, t[:, :16, :16].contiguous(), n_out=1)
    big = torch.zeros((1, 129, 129), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared-memory"):
        k3.grouped_block_matmul(z, z, z, z, big, big, n_out=1)
    with pytest.raises(ValueError, match="n_out"):
        k3.grouped_block_matmul(z, z, z, z, t, t, n_out=-1)


# -- bsr_spgemm ---------------------------------------------------------------


def both_bsr(ja, jb_, b, *, jmask=None, backend="auto"):
    jres = jx_bsr.bsr_spgemm(
        JBlocked.from_bcsr(ja, b), JBlocked.from_bcsr(jb_, b),
        mask=None if jmask is None else JBlocked.from_bcsr(jmask, b),
        backend=backend,
    )
    tmask = None if jmask is None else tp.BlockedBCSR.from_bcsr(to_port(jmask), b)
    tres = tp.bsr_spgemm(
        tp.BlockedBCSR.from_bcsr(to_port(ja), b),
        tp.BlockedBCSR.from_bcsr(to_port(jb_), b),
        mask=tmask, backend=backend, device=CPU,
    )
    assert same_blocked(jres, tres)
    return tres


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("case", ["square", "masked", "empty_mask", "empty", "rect"])
def test_bsr_spgemm_matches_jax(case, backend):
    if case == "rect":
        ja = jx.BCSR.random(96, 64, 4.0, seed=5).sum_duplicates()
        jb_ = jx.BCSR.random(64, 128, 4.0, seed=6).sum_duplicates()
        res = both_bsr(ja, jb_, 32, backend=backend)
        assert res.to_bcsr().equals(tp_oracle.spgemm_oracle(to_port(ja), to_port(jb_)))
        return
    if case == "empty":
        e = jx.BCSR.from_dense(np.zeros((64, 64)))
        res = both_bsr(e, e, 32, backend=backend)
        assert res.to_bcsr().nnz == 0 and res.n_blocks == 0
        return
    ja, ta = blocked_pair(256, 64, 2, seed=20)
    if case == "square":
        res = both_bsr(ja, ja, 64, backend=backend)
        assert res.to_bcsr().equals(tp_oracle.spgemm_oracle(ta, ta))
    elif case == "masked":
        jf, tf = blocked_pair(256, 64, 3, seed=21)
        res = both_bsr(ja, ja, 64, jmask=jf, backend=backend)
        assert res.to_bcsr().equals(tp_oracle.masked_spgemm_oracle(tf, ta, ta))
    else:
        empty = jx.BCSR.from_dense(np.zeros((256, 256)))
        res = both_bsr(ja, ja, 64, jmask=empty, backend=backend)
        assert res.to_bcsr().nnz == 0


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_bsr_spgemm_pair_chunk_loop(backend):
    ja, ta = blocked_pair(512, 32, 6, seed=7, block_density=0.1)
    blk = tp.BlockedBCSR.from_bcsr(ta, 32)
    assert len(tp_bsr.block_pairs(blk, blk)[0]) > tp_bsr.PAIR_CHUNK
    res = both_bsr(ja, ja, 32, backend=backend)
    assert res.to_bcsr().equals(tp_oracle.spgemm_oracle(ta, ta))


def test_bsr_spgemm_errors():
    _, ta = blocked_pair(128, 64, 1, seed=12)
    ab = tp.BlockedBCSR.from_bcsr(ta, 64)
    with pytest.raises(ValueError, match="unknown backend"):
        tp.bsr_spgemm(ab, ab, backend="cuda", device=CPU)
    with pytest.raises(ValueError, match="mask"):
        wrong = tp.BlockedBCSR.from_bcsr(tp.BCSR.from_dense(np.zeros((128, 128))), 32)
        tp.bsr_spgemm(ab, ab, mask=wrong, device=CPU)
    with pytest.raises(ValueError, match="block sizes"):
        tp.bsr_spgemm(ab, tp.BlockedBCSR.from_bcsr(ta, 32), device=CPU)
    rect = tp.BlockedBCSR.from_bcsr(tp.BCSR.random(64, 96, 2.0, seed=1), 64)
    with pytest.raises(ValueError, match="block shape mismatch"):
        tp.bsr_spgemm(rect, rect, device=CPU)
    with pytest.raises(ValueError, match="block sizes"):
        tp_bsr.BsrExecutor(ab, tp.BlockedBCSR.from_bcsr(ta, 32), device=CPU)
    with pytest.raises(ValueError, match="block shape mismatch"):
        tp_bsr.BsrExecutor(rect, rect, device=CPU)


def test_bsr_executor_reuse():
    j = jx.BCSR.random_blocked(512, 128, 1.5, 0.2, seed=8)
    jblk, tblk = JBlocked.from_bcsr(j, 128), tp.BlockedBCSR.from_bcsr(to_port(j), 128)
    ref = jx_bsr.bsr_spgemm(jblk, jblk)
    ex = tp_bsr.BsrExecutor(tblk, tblk, device=CPU)
    jex = jx_bsr.BsrExecutor(jblk, jblk)
    for name in ("seg", "ka", "kb", "first"):
        assert np.array_equal(np.asarray(getattr(jex, name)), getattr(ex, name).numpy())
    assert ex.a_dev.dtype == torch.bfloat16 and ex.a_dev.device.type == "cpu"
    first = ex.assemble(ex.run())
    assert same_blocked(ref, first)
    assert same_blocked(ref, ex.assemble(ex.run()))  # reuse
    assert first.to_bcsr().equals(tp_oracle.spgemm_oracle(to_port(j), to_port(j)))


# -- routing ------------------------------------------------------------------


@pytest.fixture(scope="module")
def blocked_4k():
    j = jx.BCSR.random_blocked(4096, 128, 2.0, 0.3, seed=3)
    return j, to_port(j)


def test_auto_executor_routes_blocked(blocked_4k):
    j, t = blocked_4k
    jex = jx_ell.auto_executor(j, j)
    tex = tp.auto_executor(t, t, device=CPU)
    assert isinstance(tex, tp_bsr.BsrStagedExecutor) and tex.engine == "bsr"
    assert (tex.n_chunks, tex.n_pairs, tex.n_out) == (
        jex.n_chunks, jex.n_pairs, jex.n_out
    )
    counts = tex.run()
    assert counts.shape == (tex.n_out + 1, 128, 128)
    jcounts = np.asarray(jex.run())
    assert np.array_equal(jcounts[: tex.n_out], counts[: tex.n_out].numpy())
    c = tex.assemble(counts)
    assert same(jex.assemble(jcounts), c)
    assert c.equals(tp_oracle.spgemm_oracle(t, t))
    assert tex.assemble(tex.run()).equals(c)  # repeated runs agree


def test_cached_executor_allow_bsr(blocked_4k):
    _, t = blocked_4k
    ex = tp_ell.cached_executor(t, t, allow_bsr=True, device=CPU)
    assert isinstance(ex, tp_bsr.BsrStagedExecutor)
    assert tp_ell.cached_executor(t, t, allow_bsr=True, device=CPU) is ex
    # without the opt-in the screen is not consulted: the sort engines take
    # the product, and below 2^16 rows that is the unrolled plan
    ex = tp_ell.cached_executor(t, t, device=CPU)
    assert isinstance(ex, tp_ell.EllSpGEMMExecutor) and not ex.batched
    assert ex.assemble(ex.run()).equals(tp_oracle.spgemm_oracle(t, t))


def test_spgemm_routes_blocked(blocked_4k):
    j, t = blocked_4k
    c = tp.spgemm(t, t, device=CPU)
    assert same(jx.spgemm(j, j), c)
    assert c.equals(tp_oracle.spgemm_oracle(t, t))


def test_uniform_input_declines_the_screen():
    ju = jx.BCSR.random(4096, 4096, 40.0, seed=1)
    u = tp.BCSR.random(4096, 4096, 40.0, seed=1)
    assert tp_bsr.block_clustering_ratio(u) == jx_bsr.block_clustering_ratio(ju)
    assert tp_bsr.maybe_bsr_executor(u, u, device=CPU) is None
    assert jx_bsr.maybe_bsr_executor(ju, ju) is None


def test_screen_falls_through_past_the_byte_budget(monkeypatch, blocked_4k):
    j, t = blocked_4k
    monkeypatch.setattr(tp_bsr, "BSR_MAX_STAGED_BYTES", 1 << 20)
    monkeypatch.setattr(jx_bsr, "BSR_MAX_STAGED_BYTES", 1 << 20)
    assert jx_bsr.maybe_bsr_executor(j, j) is None
    assert tp_bsr.maybe_bsr_executor(t, t, device=CPU) is None
    # auto_executor then goes on to the sort engines: the unrolled plan, as
    # in the JAX package
    jex, tex = jx_ell.auto_executor(j, j), tp.auto_executor(t, t, device=CPU)
    assert isinstance(tex, tp_ell.EllSpGEMMExecutor) and not tex.batched
    assert (tex.n_chunks, tex.sort_pad, tex.chunks) == (
        jex.n_chunks, jex.sort_pad, jex.chunks
    )
    c = tex.assemble(tex.run())
    assert same(jex.assemble(jex.run()), c)
    assert c.equals(tp_oracle.spgemm_oracle(t, t))


def test_screen_falls_through_on_memory_error(monkeypatch, blocked_4k):
    _, t = blocked_4k

    def no_memory(*args, **kwargs):
        raise MemoryError

    monkeypatch.setattr(tp_bsr.BlockedBCSR, "from_bcsr", no_memory)
    assert tp_bsr.maybe_bsr_executor(t, t, device=CPU) is None


def test_screen_on_two_operands():
    ja = jx.BCSR.random_blocked(4096, 128, 2.0, 0.3, seed=3)
    jb_ = jx.BCSR.random_blocked(4096, 128, 2.0, 0.3, seed=4)
    ta, tb_ = to_port(ja), to_port(jb_)
    ex = tp_bsr.maybe_bsr_executor(ta, tb_, device=CPU)
    jex = jx_bsr.maybe_bsr_executor(ja, jb_)
    assert ex is not None and jex is not None
    assert (ex.n_pairs, ex.n_out) == (jex.n_pairs, jex.n_out)
    assert ex.assemble(ex.run()).equals(tp_oracle.spgemm_oracle(ta, tb_))
    # a uniform right operand declines, whatever the left one
    u = tp.BCSR.random(4096, 4096, 40.0, seed=1)
    assert tp_bsr.maybe_bsr_executor(ta, u, device=CPU) is None


def test_blocked_route_opt_in():
    j = jx.BCSR.random_blocked(4096, 128, 2.0, 0.3, seed=3)
    t = to_port(j)
    c = tp_sp.blocked_route(t, t, device=CPU)
    assert c is not None and same(jx_sp.blocked_route(j, j), c)
    assert c.equals(tp_oracle.spgemm_oracle(t, t))
    # uniform input: not clustered enough
    u = tp.BCSR.random(4096, 4096, 40.0, seed=1)
    assert tp_sp.blocked_route(u, u, device=CPU) is None
    # too small to bother
    s = tp.BCSR.random_blocked(1024, 128, 2.0, 0.3, seed=3)
    assert tp_sp.blocked_route(s, s, device=CPU) is None
