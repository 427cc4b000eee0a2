"""The generators and the plain reference against scipy at tiny sizes, and
the reference against scipy at a cell's own size on a card."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spgemm_bench import gen, reference

SPRAND = {"generator": "sprand", "structure_seed": 1, "n": 3000, "d": 4}
KRON = {"generator": "kronecker", "structure_seed": 1, "scale": 9, "edge_factor": 8, "a": 0.57,
        "b": 0.19, "c": 0.19, "symmetric": True, "self_loops": False}


def _scipy(indptr, indices, n):
    return sp.csr_matrix((np.ones(len(indices), np.int64), indices, indptr), shape=(n, n))


def _canonical(indptr, indices, n):
    assert indptr.shape == (n + 1,) and indptr[0] == 0 and indptr[-1] == len(indices)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    keys = rows.astype(np.int64) * n + indices
    assert np.all(np.diff(keys) > 0)


@pytest.mark.parametrize("cfg", [SPRAND, KRON], ids=["sprand", "kronecker"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**70 + 3, -5])
def test_generators_are_canonical_and_seeded(cfg, seed):
    indptr, indices, n = gen.generate(cfg, seed)
    _canonical(indptr, indices, n)
    again = gen.generate(cfg, seed)
    assert np.array_equal(indptr, again[0]) and np.array_equal(indices, again[1])
    other = gen.generate(cfg, seed + 1)
    assert not np.array_equal(indices, other[1])


def test_sprand_density_and_kronecker_form():
    indptr, indices, n = gen.generate({"generator": "sprand", "structure_seed": 1, "n": 20000, "d": 5}, 3)
    assert abs(len(indices) / n - 5) < 0.1
    indptr, indices, n = gen.generate(KRON, 3)
    a = _scipy(indptr, indices, n)
    assert (a != a.T).nnz == 0 and a.diagonal().sum() == 0
    deg = np.diff(indptr)
    assert deg.max() > 10 * deg.mean()  # power-law rows


def test_flops_is_gustavson():
    indptr, indices, n = gen.generate(SPRAND, 1)
    a = _scipy(indptr, indices, n)
    assert gen.flops(indptr, indices) == int((a @ a).sum())


@pytest.mark.parametrize("cfg", [SPRAND, KRON], ids=["sprand", "kronecker"])
@pytest.mark.parametrize("block_flops", [1 << 27, 997])
def test_product_matches_scipy(cfg, block_flops):
    indptr, indices, n = gen.generate(cfg, 5)
    c = _scipy(indptr, indices, n) @ _scipy(indptr, indices, n)
    c.sort_indices()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(c.indptr))
    want = rows * n + c.indices
    blocks = list(reference.product_blocks(indptr, indices, n, "cpu",
                                           block_flops=block_flops))
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    got = torch.cat([k for _, _, k in blocks]).numpy()
    assert np.array_equal(got, want)
    assert (block_flops > 1 << 20) == (len(blocks) == 1)


@pytest.mark.parametrize("block_flops", [1 << 27, 1500])
def test_triangle_sum_matches_scipy(block_flops):
    indptr, indices, n = gen.generate(KRON, 9)
    a = _scipy(indptr, indices, n)
    want = int((a @ a).multiply(a).sum())
    assert want > 0 and want % 6 == 0
    assert reference.triangle_sum(indptr, indices, n, "cpu",
                                  block_flops=block_flops) == want


def test_controls_break_their_guarantee():
    indptr, indices, n = gen.generate(KRON, 9)
    a = _scipy(indptr, indices, n)
    support = int((a @ a).multiply(a).astype(bool).sum())
    assert reference.triangle_sum(indptr, indices, n, "cpu", multiplicity=False) == support
    keys = torch.cat([k for _, _, k in reference.product_blocks(
        indptr, indices, n, "cpu", dedup=False)])
    assert keys.numel() == gen.flops(indptr, indices) > (a @ a).nnz


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_file", ["sprand-n5m-d5", "g500-s15-ef16"])
def test_reference_on_card_at_cell_size(cfg_file):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the reference at a cell's own size")
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / f"{cfg_file}.json").read_text())
    indptr, indices, n = gen.generate(cfg, 2**31 + 99)
    a = _scipy(indptr, indices, n)
    c = a @ a
    c.sort_indices()
    got_nnz, off = 0, 0
    want_cols = c.indices.astype(np.int64)
    for r0, r1, keys in reference.product_blocks(indptr, indices, n, "cuda"):
        keys = keys.cpu().numpy()
        assert np.array_equal(keys // n, np.repeat(np.arange(r0, r1), np.diff(c.indptr[r0:r1 + 1])))
        assert np.array_equal(keys % n, want_cols[off : off + len(keys)])
        off += len(keys)
        got_nnz += len(keys)
    assert got_nnz == c.nnz
    if cfg["generator"] == "kronecker":
        want = int(c.multiply(a).sum())
        assert reference.triangle_sum(indptr, indices, n, "cuda") == want


@pytest.mark.parametrize("cfg", [SPRAND, KRON], ids=["sprand", "kronecker"])
def test_seeds_relabel_one_structure(cfg):
    """Every seed keeps each row's length and flops (the same sizes, in
    another order) and relabels one matrix: P A P^T."""
    a0 = gen.GENERATORS[cfg["generator"]](cfg, gen.rng_for(cfg["structure_seed"]))
    s0 = _scipy(*a0)
    lens0 = np.diff(a0[0])
    rf0 = (s0 @ s0).sum(axis=1).A1
    for seed in (3, 2**31 + 5):
        indptr, indices, n = gen.generate(cfg, seed)
        s = _scipy(indptr, indices, n)
        assert np.array_equal(np.diff(indptr), lens0)
        assert np.array_equal((s @ s).sum(axis=1).A1, rf0)
        assert s.nnz == s0.nnz and (s @ s).nnz == (s0 @ s0).nnz
        if cfg.get("symmetric"):
            assert (s != s.T).nnz == 0 and s.diagonal().sum() == 0
            assert (s @ s).multiply(s).sum() == (s0 @ s0).multiply(s0).sum()


def test_unrelabeled_config_is_one_matrix_for_every_seed():
    cfg = {**SPRAND, "relabel": False}
    base = gen.GENERATORS["sprand"](cfg, gen.rng_for(cfg["structure_seed"]))
    for seed in (3, 2**31 + 5):
        got = gen.generate(cfg, seed)
        assert np.array_equal(got[0], base[0]) and np.array_equal(got[1], base[1])
