"""The port's CLI (``binary_spgemm_tpu_torch.cli``: ``gen``, ``multiply``,
``graph``, ``validate``, ``bench``) against the JAX package's, on the CPU
(``--device cpu``): the same commands on the same files write byte-equal
output files and print the same lines, whatever engine or route the port
takes; the error exits (code 2) are the JAX CLI's; ``--resident`` is the JAX
CLI's ``graph --device``; ``validate`` over launched gloo ranks prints the
JAX CLI's lines; ``bench`` prints the JAX CLI's CSV fields and JSON keys,
and its scaling report the JAX report's keys."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import binary_spgemm_tpu as jx
from binary_spgemm_tpu import cli as jx_cli

from binary_spgemm_tpu_torch import cli as tp_cli
from binary_spgemm_tpu_torch.io.mmio import read_pattern
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture
def mtx(tmp_path):
    p = tmp_path / "a.mtx"
    jx.write_pattern(p, jx.BCSR.random(200, 200, 2.0, seed=1))
    return str(p)


@pytest.fixture
def sparse_mtx(tmp_path):
    # its closure's rounds stay on both packages' host engines
    p = tmp_path / "s.mtx"
    jx.write_pattern(p, jx.BCSR.random(200, 200, 1.2, seed=1))
    return str(p)


@pytest.fixture
def sym_mtx(tmp_path):
    sp = jx.BCSR.random(80, 80, 3.0, seed=4).to_scipy()
    sp = ((sp + sp.T) > 0).astype(np.int64).tolil()
    sp.setdiag(0)
    p = tmp_path / "g.mtx"
    jx.write_pattern(p, jx.BCSR.from_scipy(sp.tocsr()))
    return str(p)


def both(capsys, jax_argv, port_argv):
    """Run the JAX CLI, then the port's; return their stdouts (each call
    must exit 0)."""
    assert jx_cli.main(jax_argv) == 0
    j = capsys.readouterr().out
    assert tp_cli.main(port_argv) == 0
    return j, capsys.readouterr().out


def same_bytes(p, q):
    with open(p, "rb") as fp, open(q, "rb") as fq:
        return fp.read() == fq.read()


@pytest.mark.parametrize("rmat", [False, True])
def test_gen_writes_the_jax_clis_file(tmp_path, capsys, rmat):
    j_out, t_out = str(tmp_path / "j.mtx"), str(tmp_path / "t.mtx")
    args = ["-n", "256", "-d", "1.5", "--seed", "9"] + (["--rmat"] if rmat else [])
    jo, to = both(capsys, ["gen", j_out, *args], ["gen", t_out, *args])
    assert same_bytes(j_out, t_out)
    assert jo.replace(j_out, "X") == to.replace(t_out, "X")
    with pytest.raises(SystemExit):
        tp_cli.main(["gen", t_out, "-n", "300", "-d", "1.0", "--rmat"])


@pytest.mark.parametrize("extra", [[], ["--engine", "esc", "--chunk-flops", "4096"],
                                   ["--engine", "esc"], ["--engine", "ell"],
                                   ["--chunk-flops", "2048"]])
def test_multiply_writes_the_jax_clis_file(mtx, tmp_path, capsys, extra):
    # the JAX CLI's auto engine (its host engine at this size) against every
    # engine of the port: one product, byte-equal files
    j_out, t_out = str(tmp_path / "j.mtx"), str(tmp_path / "t.mtx")
    jo, to = both(capsys, ["multiply", mtx, "--out", j_out],
                  ["multiply", mtx, "--out", t_out, *extra, *CPU])
    assert same_bytes(j_out, t_out)
    assert jo.replace(j_out, "X") == to.replace(t_out, "X")
    a = read_pattern(mtx)
    assert read_pattern(t_out, transpose=False).equals(spgemm_oracle(a, a))


@pytest.mark.parametrize("op", ["mask", "fuse-or", "fuse-or mask", "b", "no-transpose"])
def test_multiply_variants_write_the_jax_clis_file(mtx, tmp_path, capsys, op):
    f, d, b = (str(tmp_path / x) for x in ("f.mtx", "d.mtx", "b.mtx"))
    jx.write_pattern(f, jx.BCSR.random(200, 200, 3.0, seed=5))
    jx.write_pattern(d, jx.BCSR.random(200, 200, 1.0, seed=6))
    jx.write_pattern(b, jx.BCSR.random(200, 200, 2.5, seed=7))
    extra = {"mask": ["--mask", f], "fuse-or": ["--fuse-or", d],
             "fuse-or mask": ["--fuse-or", d, "--mask", f], "b": [b],
             "no-transpose": ["--no-transpose"]}[op]
    j_out, t_out = str(tmp_path / "j.mtx"), str(tmp_path / "t.mtx")
    jo, to = both(capsys, ["multiply", mtx, *extra, "--out", j_out],
                  ["multiply", mtx, *extra, "--out", t_out, *CPU])
    assert same_bytes(j_out, t_out)
    assert jo.replace(j_out, "X") == to.replace(t_out, "X")


@pytest.mark.parametrize("extra", [[], ["--engine", "esc"], ["--mask", "F"]])
def test_multiply_counts_writes_the_jax_clis_file(mtx, tmp_path, capsys, extra):
    f = str(tmp_path / "f.mtx")
    jx.write_pattern(f, jx.BCSR.random(200, 200, 3.0, seed=5))
    extra = [f if x == "F" else x for x in extra]
    j_out, t_out = str(tmp_path / "j.mtx"), str(tmp_path / "t.mtx")
    jo, to = both(capsys, ["multiply", mtx, "--counts", *extra, "--out", j_out],
                  ["multiply", mtx, "--counts", *extra, "--out", t_out, *CPU])
    assert same_bytes(j_out, t_out)
    assert "sum(counts)=" in to and jo.replace(j_out, "X") == to.replace(t_out, "X")
    with open(t_out) as fh:
        assert fh.readline().strip() == "%%MatrixMarket matrix coordinate integer general"


def test_multiply_counts_rejects_fuse_or(mtx):
    assert tp_cli.main(["multiply", mtx, "--counts", "--fuse-or", mtx, *CPU]) == 2


@pytest.mark.parametrize("route", [[], ["--resident"], ["--resident", "--two-sort"],
                                   ["--chunk-flops", "2048"]])
@pytest.mark.parametrize("op", [["closure"], ["khop", "--k", "3"], ["khop"],
                                ["closure", "--max-iters", "2"]])
def test_graph_closure_and_khop_write_the_jax_clis_file(sparse_mtx, tmp_path, capsys, op,
                                                       route):
    # the JAX CLI's host route against every route of the port
    j_out, t_out = str(tmp_path / "j.mtx"), str(tmp_path / "t.mtx")
    jo, to = both(capsys, ["graph", sparse_mtx, *op, "--out", j_out],
                  ["graph", sparse_mtx, *op, *route, "--out", t_out, *CPU])
    assert same_bytes(j_out, t_out)
    assert jo.replace(j_out, "X") == to.replace(t_out, "X")


@pytest.mark.parametrize("op", [["triangles"], ["ktruss", "--k", "3"],
                                ["ktruss", "--k", "4"]])
def test_graph_triangles_and_ktruss_write_the_jax_clis_file(sym_mtx, tmp_path, capsys, op):
    j_out, t_out = str(tmp_path / "j.mtx"), str(tmp_path / "t.mtx")
    jo, to = both(capsys, ["graph", sym_mtx, *op, "--out", j_out],
                  ["graph", sym_mtx, *op, "--out", t_out, *CPU])
    assert same_bytes(j_out, t_out)
    assert jo.replace(j_out, "X") == to.replace(t_out, "X")


def test_graph_triangle_count_prints_the_jax_clis_line(sym_mtx, tmp_path, capsys):
    k4 = str(tmp_path / "k4.mtx")
    jx.write_pattern(k4, jx.BCSR.from_dense(~np.eye(4, dtype=bool)))
    for path in (sym_mtx, k4):
        jo, to = both(capsys, ["graph", path, "triangles", "--count", "--no-transpose"],
                      ["graph", path, "triangles", "--count", "--no-transpose", *CPU])
        assert jo == to
    assert "count=4" in to


@pytest.mark.parametrize("out", [False, True])
def test_graph_bfs_and_clustering_write_the_jax_clis_csv(mtx, sym_mtx, tmp_path, capsys, out):
    for path, op in ((mtx, ["bfs", "--sources", "0,5"]), (mtx, ["bfs", "--sources", "2"]),
                     (sym_mtx, ["clustering"])):
        j_out, t_out = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
        jo, to = both(capsys, ["graph", path, *op] + (["--out", j_out] if out else []),
                      ["graph", path, *op, *CPU] + (["--out", t_out] if out else []))
        assert jo.replace(j_out, "X") == to.replace(t_out, "X")
        if out:
            assert same_bytes(j_out, t_out)


@pytest.mark.parametrize("argv", [["bfs"], ["bfs", "--sources", "0,x"],
                                  ["bfs", "--sources", "1", "--resident"],
                                  ["triangles", "--resident"],
                                  ["clustering", "--resident"],
                                  ["ktruss", "--k", "3", "--resident"],
                                  ["ktruss", "--k", "2"]])
def test_graph_error_exits_are_the_jax_clis(mtx, argv):
    jax_argv = ["--device" if x == "--resident" else x for x in argv]
    assert jx_cli.main(["graph", mtx, *jax_argv]) == 2
    assert tp_cli.main(["graph", mtx, *argv, *CPU]) == 2


def test_parser_names():
    p = tp_cli.build_parser()
    args = p.parse_args(["graph", "a.mtx", "closure"])
    assert args.device == "cuda" and args.resident is False and args.two_sort is False
    assert p.parse_args(["multiply", "a.mtx"]).device == "cuda"
    args = p.parse_args(["validate", "a.mtx"])
    assert (args.device, args.devices, args.balance, args.b_layout, args.engine,
            args.oracle) == ("cuda", None, "flops", "replicated", "auto", False)
    # bench parses with the JAX CLI's defaults, plus --device
    j = vars(jx_cli.build_parser().parse_args(["bench", "a.mtx"]))
    t = vars(p.parse_args(["bench", "a.mtx"]))
    assert t.pop("device") == "cuda"
    assert {k: v for k, v in t.items() if k != "fn"} == {k: v for k, v in j.items()
                                                          if k != "fn"}
    assert t["fn"] is tp_cli.cmd_bench


@pytest.mark.parametrize("argv", [
    ["--oracle", "--devices", "2", "--b-layout", "ring", "--balance", "rows"],
    ["--devices", "1", "--engine", "ell", "--b-layout", "sharded"],
])
def test_validate_prints_the_jax_clis_lines(mtx, capsys, argv):
    """``validate`` over 2 gloo ranks (and one process alone) prints the JAX
    CLI's confirm line on the same file and flags."""
    j, t = both(capsys, ["validate", mtx, *argv], ["validate", mtx, *argv, *CPU])
    assert j == t == "Results of serial and multicore are the same!\n"


def test_validate_defaults_to_the_card(mtx):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp_cli.main(["validate", mtx])


@pytest.mark.parametrize("local, world, cards, device, want", [
    ("2", "2", 1, "cuda", "gloo"),   # two ranks share the one card: NCCL refuses
    ("1", "1", 1, "cuda", "nccl"),
    ("4", "8", 4, "cuda", "nccl"),   # two machines of four cards each
    ("8", "8", 4, "cuda", "gloo"),
    (None, "2", 2, "cuda", "nccl"),  # no LOCAL_WORLD_SIZE: the world's ranks
    ("1", "1", 1, "cpu", "gloo"),
])
def test_torchrun_backend_rule(monkeypatch, local, world, cards, device, want):
    """Under ``torchrun`` the backend follows ``launch.default_backend``'s
    rule over the ranks on this machine (``LOCAL_WORLD_SIZE``) against its
    card count."""
    import torch

    from binary_spgemm_tpu_torch.parallel import launch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("WORLD_SIZE", world)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert launch.torchrun_backend(device) == want
    assert launch.default_backend(int(local or world), device) == want


class _Initialised(Exception):
    pass


@pytest.mark.parametrize("local, want", [("2", "gloo"), ("1", "nccl")])
def test_validate_under_torchrun_takes_the_rule(mtx, monkeypatch, local, want):
    """``validate --device cuda`` under ``torchrun`` env starts its group
    with the rule's backend: gloo for two ranks on a one-card machine."""
    import torch

    from binary_spgemm_tpu_torch.parallel import multihost

    got = []

    def initialize(backend="nccl", **kwargs):
        got.append(backend)
        raise _Initialised

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(multihost, "initialize", initialize)
    for key, value in (("RANK", "0"), ("WORLD_SIZE", local), ("LOCAL_WORLD_SIZE", local)):
        monkeypatch.setenv(key, value)
    with pytest.raises(_Initialised):
        tp_cli.main(["validate", mtx, "--device", "cuda"])
    assert got == [want]


def test_validate_under_torchrun_without_a_card_raises(mtx, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_WORLD_SIZE", "1")):
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp_cli.main(["validate", mtx])


def test_validate_joins_a_torchrun_group(mtx):
    """``validate --device cpu`` in a process with ``torchrun``'s variables
    (rank 0 of 1) starts a gloo group at ``env://`` and prints the confirm
    line."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    res = subprocess.run([sys.executable, "-m", "binary_spgemm_tpu_torch.cli", "validate",
                          mtx, "--device", "cpu", "--oracle"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout == "Results of serial and multicore are the same!\n"


def test_resident_route_defaults_to_the_card(mtx):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp_cli.main(["graph", mtx, "closure", "--resident"])


def test_module_entry_point_and_script(tmp_path):
    out = str(tmp_path / "g.mtx")
    res = subprocess.run([sys.executable, "-m", "binary_spgemm_tpu_torch.cli", "gen", out,
                          "-n", "64", "-d", "2", "--seed", "3"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"wrote {out}: n=64 nnz=" in res.stdout
    assert read_pattern(out, transpose=False).shape == (64, 64)
    with open(os.path.join(ROOT, "pyproject.toml")) as fh:
        assert 'binary-spgemm-tpu-torch = "binary_spgemm_tpu_torch.cli:main"' in fh.read()


def bench_lines(capsys, jax_argv, port_argv):
    """stdout lines of the JAX CLI's ``bench``, then the port's."""
    j, t = both(capsys, ["bench", *jax_argv], ["bench", *port_argv, *CPU])
    return j.strip().splitlines(), t.strip().splitlines()


def test_bench_csv_schema(mtx, capsys):
    j, t = bench_lines(capsys, [mtx, "--times", "2", "--json"],
                       [mtx, "--times", "2", "--json"])
    csv = t[0].split(",")
    # tasks,threads,total_cpus,blocksize,path,n,input_nnz,output_nnz,mean,median,fastest
    assert len(csv) == len(j[0].split(",")) == 11
    assert csv[:8] == j[0].split(",")[:8] == ["1", "1", "1", "0", mtx, "200",
                                               csv[6], csv[7]]
    assert float(csv[8]) > 0 and float(csv[10]) <= float(csv[8]) * 1.5
    rec, jrec = json.loads(t[1]), json.loads(j[1])
    assert sorted(rec) == sorted(jrec)
    assert rec["n"] == 200 and rec["output_nnz"] == int(csv[7]) == jrec["output_nnz"]
    assert rec["output_nnz_per_s"] > 0 and rec["platform"] == "cpu"
    assert (rec["flops"], rec["input_nnz"]) == (jrec["flops"], jrec["input_nnz"])


def test_bench_multidevice(mtx, capsys):
    """``--devices 4`` starts 4 gloo ranks; the CSV names 4 tasks and the
    JAX CLI's output nnz."""
    j, t = bench_lines(capsys, [mtx, "--times", "1", "--devices", "4"],
                       [mtx, "--times", "1", "--devices", "4"])
    csv = t[0].split(",")
    assert csv[0] == "4" and csv[:8] == j[0].split(",")[:8]


def test_bench_rejects_rectangular(tmp_path):
    p = str(tmp_path / "r.mtx")
    jx.write_pattern(p, jx.BCSR.random(20, 30, 1.0, seed=0))
    assert jx_cli.main(["bench", p, "--no-transpose"]) == 2
    assert tp_cli.main(["bench", p, "--no-transpose", *CPU]) == 2


def test_bench_tune(mtx, capsys):
    # --tune measures the model's plausibly best batched plans and benches
    # the winner (a staged executor)
    j, t = bench_lines(capsys, [mtx, "--tune", "--times", "1", "--json"],
                       [mtx, "--tune", "--times", "1", "--json"])
    assert len(t[0].split(",")) == len(j[0].split(",")) == 11
    assert json.loads(t[1])["output_nnz"] == json.loads(j[1])["output_nnz"] > 0


def test_bench_blocksize_sweep(mtx, capsys):
    j, t = bench_lines(capsys, [mtx, "--times", "1", "--sweep", "4096,16384"],
                       [mtx, "--times", "1", "--sweep", "4096,16384"])
    lines = [line for line in t if "," in line]
    assert len(lines) == 2
    assert lines[0].split(",")[3] == "4096" and lines[1].split(",")[3] == "16384"
    assert [x.split(",")[:8] for x in lines] == [x.split(",")[:8] for x in j if "," in x]


def test_scaling_report_cli(tmp_path, capsys):
    """``bench --scaling-report --devices 2 --json``: the JAX report's keys,
    counts 1 and 2, bit-exact at 2 ranks."""
    path = str(tmp_path / "m.mtx")
    jx.write_pattern(path, jx.BCSR.random(500, 500, 3.0, seed=4))
    j, t = bench_lines(capsys, [path, "--scaling-report", "--devices", "2", "--times",
                                "1", "--json"],
                       [path, "--scaling-report", "--devices", "2", "--times", "1",
                        "--json"])
    rep, jrep = json.loads(t[-1]), json.loads(j[-1])
    assert rep["kind"] == "scaling_report" and sorted(rep) == sorted(jrep)
    assert [r["devices"] for r in rep["rows"]] == [1, 2]
    assert rep["bit_exact"] is True and rep["platform"] == "cpu"
    assert sorted(rep["rows"][0]) == sorted(jrep["rows"][0])
