"""K3's two kernels on the CPU: which one takes which arguments
(``k3_variant``), the pipe kernel's persistent grid (``k3_grid``), a numpy
model of the pipe kernel's schedule held against the plain version, and the
CPU contract of ``_grouped_block_matmul_variant``.  The CUDA kernels
themselves run in ``tests/test_torch_cuda.py`` on a card."""
import bisect

import numpy as np
import pytest
import torch

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import block_matmul as k3
from binary_spgemm_tpu_torch.ops import bsr as tp_bsr

STAGES = 2  # the ring's stages in csrc/block_matmul.cu (PipeTile::kStages)


@pytest.mark.parametrize(
    "b,aligned,want",
    [(1, True, "simple"), (7, True, "simple"), (8, True, "pipe"),
     (16, True, "pipe"), (100, True, "simple"), (104, True, "pipe"),
     (120, True, "pipe"), (128, True, "pipe"), (128, False, "simple"),
     (8, False, "simple"), (64, False, "simple")],
)
def test_k3_variant(b, aligned, want):
    assert k3.k3_variant(b, aligned) == want


@pytest.mark.parametrize(
    "n_out,sms,per_sm,want",
    [(1107, 132, 1, 132), (100, 132, 1, 100), (1107, 132, 4, 528), (1, 132, 1, 1)],
)
def test_k3_grid(n_out, sms, per_sm, want):
    assert k3.k3_grid(n_out, sms, per_sm) == want


def test_k3_grid_rejects_an_empty_card():
    with pytest.raises(ValueError, match="per_sm"):
        k3.k3_grid(10, 132, 0)


# -- a numpy model of the pipe kernel's schedule ------------------------------


THREADS = 256  # threads of a pipe block: the walk's pair ranges are searched this many at once


def pipe_walk(seg, ka, kb, n_out, n_a, n_b, grid):
    """The events of ``grouped_block_matmul_pipe_kernel``, block by block, in
    each block's program order, with the kernel's cursor and ring arithmetic:
    ``("search", w)`` (the ranges of walk entries w ... w + THREADS - 1),
    ``("zero", s)``, ``("copy", p, stage, counts)`` (``p`` None for the
    empty group of a step past the walk's end), ``("mma", p, stage)`` and
    ``("epilogue", s)``."""
    seg = [int(x) for x in seg]
    npairs = len(seg)
    walks = []
    for c in range(grid):
        ev = []
        cur = {"w": -1, "fs": 0, "fp": -1, "fhi": 0, "walking": True}
        ranges = {}

        def advance():
            cur["fp"] += 1
            while cur["fp"] >= cur["fhi"]:
                cur["w"] += 1
                nxt = c + cur["w"] * grid
                if nxt >= n_out:
                    return False
                cur["fs"] = nxt
                if cur["w"] % THREADS == 0:  # one search per thread, at once
                    ev.append(("search", cur["w"]))
                    ranges.clear()
                    for j in range(THREADS):
                        sj = nxt + j * grid
                        if sj < n_out:
                            lo = bisect.bisect_left(seg, sj, 0, npairs)
                            ranges[j] = (lo, bisect.bisect_left(seg, sj + 1, lo, npairs))
                cur["fp"], cur["fhi"] = ranges[cur["w"] % THREADS]
                if cur["fp"] == cur["fhi"]:
                    ev.append(("zero", nxt))
            return True

        def fetch(st):
            """(exists, output block, last of its block, counts)."""
            cur["walking"] = cur["walking"] and advance()
            if not cur["walking"]:
                ev.append(("copy", None, st, False))
                return (False, None, None, False)
            p = cur["fp"]
            ok = 0 <= ka[p] < n_a and 0 <= kb[p] < n_b
            ev.append(("copy", p, st, ok))
            return (True, cur["fs"], p == cur["fhi"] - 1, ok, p)

        q = [fetch(i) for i in range(STAGES - 1)]
        if q[0][0]:
            t = 0
            while True:
                q.append(fetch((t + STAGES - 1) % STAGES))
                has, s, last, ok = q[0][:4]
                if ok:
                    ev.append(("mma", q[0][4], t % STAGES))
                if last:
                    ev.append(("epilogue", s))
                if not q[1][0]:
                    break
                q.pop(0)
                t += 1
        walks.append(ev)
    return walks


def replay(walks, seg, ka, kb, ta, tb, n_out):
    """Run the events in int64, checking the ring as it goes; returns the
    output tiles and how often each output block was written."""
    b = ta.shape[-1]
    out = np.full((n_out, b, b), -1, np.int64)
    written = np.zeros(n_out, np.int64)
    for ev in walks:
        ring = [None] * STAGES  # [pair the stage holds, its MMAs done]
        acc = np.zeros((b, b), np.int64)
        steps = [e for e in ev if e[0] == "copy"]
        for i, e in enumerate(steps):  # one group per step, in stage step mod STAGES
            assert e[2] == i % STAGES
        for e in ev:
            if e[0] == "search":
                continue
            if e[0] == "copy":
                _, p, st, ok = e
                # the stage it fills holds no pair still waiting for its MMAs
                assert ring[st] is None or ring[st][1], (p, st)
                ring[st] = [p, not ok]  # a skipped pair has no copies to wait for
            elif e[0] == "mma":
                _, p, st = e
                assert ring[st] == [p, False]
                ring[st][1] = True
                acc += ta[ka[p]].astype(np.int64) @ tb[kb[p]].astype(np.int64)
            elif e[0] == "epilogue":
                out[e[1]] = acc
                written[e[1]] += 1
                acc = np.zeros((b, b), np.int64)
            else:
                out[e[1]] = 0
                written[e[1]] += 1
    return out, written


def prefetch_order_holds(walk, seg):
    """Pair t + 1's copies start before pair t's MMAs, also where t + 1
    opens the next output block; returns how many such crossings there were."""
    started = [e[1] for e in walk if e[0] == "copy" and e[1] is not None]
    pos = {("copy", e[1]): i for i, e in enumerate(walk) if e[0] == "copy"}
    pos.update({("mma", e[1]): i for i, e in enumerate(walk) if e[0] == "mma"})
    crossings = 0
    for t, p in enumerate(started[:-1]):
        q = started[t + 1]
        if ("mma", p) in pos:
            assert pos[("copy", q)] < pos[("mma", p)], (p, q)
        if seg[q] != seg[p]:
            crossings += 1
    return crossings


def plan(case):
    rng = np.random.default_rng(len(case))
    if case == "random_blocked":
        blk = tp.BlockedBCSR.from_bcsr(tp.BCSR.random_blocked(512, 32, 2.0, 0.3, seed=5), 32)
        ka, kb, seg, obr, _ = tp_bsr.block_pairs(blk, blk)
        seg_p, ka_p, kb_p, _ = tp_bsr._pad_pair_plan(ka, kb, seg, len(obr))
        assert (seg_p == len(obr)).any()  # the padded tail into the scratch block
        return seg_p, ka_p, kb_p, blk.blocks, blk.blocks, len(obr) + 1
    b = 16 if case == "long_group" else 8
    groups = {"empty_middle": [2, 0, 3, 1, 0, 2], "long_group": [230, 1, 2],
              "no_pairs": [0, 0, 0, 0, 0],
              # more output blocks than one range search covers at grid 1 and 3
              "many_blocks": (np.arange(900) % 3).tolist()}[case]
    n_a, n_b = 5, 4
    ta = (rng.random((n_a, b, b)) < 0.4).astype(np.uint8)
    tb = (rng.random((n_b, b, b)) < 0.4).astype(np.uint8)
    seg = np.repeat(np.arange(len(groups)), groups).astype(np.int32)
    ka = rng.integers(0, n_a, len(seg)).astype(np.int32)
    kb = rng.integers(0, n_b, len(seg)).astype(np.int32)
    if case == "empty_middle":
        ka[1], kb[3] = n_a, -1  # out of range: these pairs contribute nothing
    return seg, ka, kb, ta, tb, len(groups) + 1


@pytest.mark.parametrize("grid", [1, 3, 132, "past_n_out"])
@pytest.mark.parametrize(
    "case", ["empty_middle", "long_group", "no_pairs", "random_blocked", "many_blocks"]
)
def test_pipe_schedule_model_equals_the_plain_version(case, grid):
    seg, ka, kb, ta, tb, n_out = plan(case)
    grid = n_out + 5 if grid == "past_n_out" else grid
    walks = pipe_walk(seg, ka, kb, n_out, ta.shape[0], tb.shape[0], grid)
    out, written = replay(walks, seg, ka, kb, ta, tb, n_out)
    assert (written == 1).all()  # every output block exactly once
    want = k3.grouped_block_matmul_plain(
        *(torch.from_numpy(np.asarray(x, np.int32)) for x in (seg, ka, kb, seg)),
        torch.from_numpy(ta).to(torch.bfloat16), torch.from_numpy(tb).to(torch.bfloat16),
        n_out=n_out,
    )
    assert np.array_equal(out, want.numpy().astype(np.int64))
    # block c's cursor walks s = c, c + grid, ... in that order, and writes
    # exactly those blocks (an empty one as the cursor passes it, so perhaps
    # before the epilogue of the block before it)
    for c, walk in enumerate(walks):
        visits = []
        for e in walk:
            s = (e[1] if e[0] == "zero"
                 else int(seg[e[1]]) if e[0] == "copy" and e[1] is not None else None)
            if s is not None and (not visits or visits[-1] != s):
                visits.append(s)
        assert visits == list(range(c, n_out, grid))
        done = [e[1] for e in walk if e[0] in ("zero", "epilogue")]
        assert sorted(done) == visits
    crossings = sum(prefetch_order_holds(w, seg) for w in walks)
    if case in ("empty_middle", "random_blocked", "many_blocks") and grid < n_out:
        assert crossings > 0  # the prefetch did cross output-block boundaries
    if case == "no_pairs":
        assert not any(e[0] == "copy" and e[1] is not None for w in walks for e in w)
    # the ranges are searched once per THREADS output blocks of a walk
    for c, walk in enumerate(walks):
        searches = [e[1] for e in walk if e[0] == "search"]
        assert searches == list(range(0, len(range(c, n_out, grid)), THREADS))


# -- the variant entry point on the CPU --------------------------------------


def cpu_args(b, n_pairs=3, offset=0):
    rng = np.random.default_rng(b)
    seg = torch.tensor(sorted(rng.integers(0, 2, n_pairs)), dtype=torch.int32)
    ka = torch.from_numpy(rng.integers(0, 2, n_pairs).astype(np.int32))
    kb = torch.from_numpy(rng.integers(0, 2, n_pairs).astype(np.int32))
    first = torch.zeros(n_pairs, dtype=torch.int32)
    tiles = []
    for _ in range(2):
        flat = torch.from_numpy((rng.random(2 * b * b + offset) < 0.4).astype(np.float32))
        tiles.append(flat.to(torch.bfloat16)[offset:].view(2, b, b))
    return [seg, ka, kb, first, *tiles]


@pytest.mark.parametrize("b,variant", [(8, "pipe"), (128, "pipe"), (7, "simple"), (100, "simple"),
                                       (128, "simple")])
def test_variant_entry_on_the_cpu_is_the_plain_version(b, variant):
    args = cpu_args(b)
    before = (k3.grouped_block_matmul.launches, dict(k3.grouped_block_matmul.launches_by_variant))
    got = k3._grouped_block_matmul_variant(*args, n_out=3, variant=variant)
    assert torch.equal(got, k3.grouped_block_matmul_plain(*args, n_out=3))
    assert torch.equal(got, k3.grouped_block_matmul(*args, n_out=3))
    # a CPU tensor is computed by the plain version: no launch is counted
    after = (k3.grouped_block_matmul.launches, dict(k3.grouped_block_matmul.launches_by_variant))
    assert after == before


def test_variant_entry_raises_where_the_kernel_cannot_take_the_arguments():
    with pytest.raises(ValueError, match="unknown K3 variant"):
        k3._grouped_block_matmul_variant(*cpu_args(16), n_out=3, variant="bmm")
    for b in (7, 100):  # not a multiple of 8
        with pytest.raises(ValueError, match="'pipe'"):
            k3._grouped_block_matmul_variant(*cpu_args(b), n_out=3, variant="pipe")
    misaligned = cpu_args(16, offset=1)  # tiles start 2 bytes past an aligned address
    assert misaligned[4].data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="aligned False"):
        k3._grouped_block_matmul_variant(*misaligned, n_out=3, variant="pipe")
    # the wrapper itself takes the simple kernel there, and on the CPU computes
    # the plain version
    assert k3.k3_variant(16, False) == "simple"
    got = k3.grouped_block_matmul(*misaligned, n_out=3)
    assert torch.equal(got, k3.grouped_block_matmul_plain(*misaligned, n_out=3))
    # the shared argument checks still come first
    with pytest.raises(ValueError, match="int32"):
        args = cpu_args(16)
        args[0] = args[0].long()
        k3._grouped_block_matmul_variant(*args, n_out=3, variant="pipe")
