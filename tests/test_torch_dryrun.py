"""The port's multi-rank dry run (``parallel/dryrun.py``): ``main`` launches
a world of four gloo CPU ranks itself (a file rendezvous in a temporary
directory) and makes the JAX dry run's proofs there; it prints the JAX
summary line. Proof 4, the concurrent ``--shard`` processes, is left out
with ``--no-shards``: ``test_torch_shardproof.py`` makes it."""

from iv_interpolation_tpu_torch.parallel import dryrun


def test_dryrun_main_four_cpu_ranks(capsys):
    assert dryrun.main(["--ranks", "4", "--device", "cpu", "--no-shards",
                        "--timeout", "300"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh=(2x2) platform=cpu backend=gloo ranks=4")
    for part in ("w_grid=(8, 6, 16)", "bad_surfaces=0",
                 "pipeline_tables_sharded_vs_single_device=BYTE_IDENTICAL",
                 "method_parity_PASS=cubic_spline+svi+essvi+sabr+smoothing_spline+rbf+ah",
                 "concurrent_shard_processes=NOT_RUN"):
        assert part in line, line


def test_summary_line_with_the_shard_proof():
    res = {"mesh": [2, 1], "device": "cuda:0", "backend": "gloo", "ranks": 2,
           "w_grid": [8, 6, 16], "bad_surfaces": 0, "methods": ["cubic_spline"],
           "shards": {"wall_s": 3.25}}
    line = dryrun.summary_line(res)
    assert "mesh=(2x1)" in line and line.endswith(
        "concurrent_shard_processes=PASS (2 simultaneous procs, 3.25s overlap, "
        "tables byte-equal unsharded)")
