"""A cell on several cards, on the CPU: harness.merge_results on hand-made
results of 2-4 ranks, and run.py's launch, collection and merge over two
gloo ranks (tests/_cpu_ranks.py, the fixture under tests/ranks/), each
launch under a time limit of its own."""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import pytest

from _tiny import ROOT
from splatbench import harness

CPU_RANKS = os.path.join(ROOT, "splatbench", "tests", "_cpu_ranks.py")
FIXTURE = os.path.join(ROOT, "splatbench", "tests", "ranks",
                       "BENCHMARK.json")
TIMEOUT_S = 120


def _rank(rank=0, correct=True, checks=None, failed=0, peak=1000,
          power=700.0, busy=None):
    checks = checks if checks is not None else {"err": 0.0}
    res = {"correct": correct, "attempted": 10 + rank, "failed": failed,
           "metrics": {"step_ms": {"value": 5.0 + rank, "unit": "ms"}}}
    if busy is not None:
        res["breakdown"] = {"device_ops": [[f"k{rank}", 1.0]],
                            "idle_gaps": []}
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": peak, "power_limit_w": power,
           "pci_bus_id": f"00000000:{rank:02X}:00.0"}
    if busy is not None:
        dev.update(busy_s=busy, window_s=2.0, collective_s=busy / 2 - 0.25)
    res["device"] = dev
    res["info"] = {"rank_info": rank}
    res["checks"] = {k: {"value": v, "limit": 1e-3}
                     for k, v in checks.items()}
    return res


def test_one_rank_gives_back_its_input():
    r = _rank()
    del r["device"]["pci_bus_id"]
    assert harness.merge_results([r]) is r


@pytest.mark.parametrize("world,bad", [(2, 1), (3, 0), (4, 2)])
def test_one_rank_out_of_its_limit_is_not_correct(world, bad):
    ranks = [_rank(r, correct=r != bad,
                   checks={"err": 5e-3 if r == bad else 1e-4 * r,
                           "gap": 1e-5})
             for r in range(world)]
    out = harness.merge_results(ranks)
    assert out["correct"] is False
    assert out["checks"]["err"] == {"value": 5e-3, "limit": 1e-3}
    assert out["checks"]["gap"] == {"value": 1e-5, "limit": 1e-3}
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "info", "checks"]
    good = harness.merge_results([_rank(r) for r in range(world)])
    assert good["correct"] is True


def test_a_rank_that_checked_nothing_is_allowed():
    # Rank 1 checked nothing (correct false with every number within its
    # limit, as run.py makes it): the others' checks decide.
    ranks = [_rank(0), _rank(1, correct=False, checks={}), _rank(2)]
    assert harness.merge_results(ranks)["correct"] is True
    none = [_rank(r, correct=False, checks={}) for r in range(2)]
    assert harness.merge_results(none)["correct"] is False


def test_a_nan_reading_is_the_worst():
    ranks = [_rank(0, correct=False, checks={"err": float("nan")}),
             _rank(1, checks={"err": 1e-4})]
    out = harness.merge_results(ranks)
    assert math.isnan(out["checks"]["err"]["value"])
    assert out["correct"] is False
    out = harness.merge_results(ranks[::-1])
    assert math.isnan(out["checks"]["err"]["value"])


def test_peak_busy_power_and_counts_follow_the_rules():
    ranks = [_rank(0, failed=3, peak=5_000, power=700.0, busy=1.0),
             _rank(1, failed=4, peak=9_000, power=650.0, busy=1.5),
             _rank(2, failed=6, peak=7_000, power=700.0, busy=0.5),
             _rank(3, failed=0, peak=1_000, power=None, busy=2.0)]
    before = copy.deepcopy(ranks)
    out = harness.merge_results(ranks)
    assert ranks == before
    assert out["attempted"] == 10
    assert out["failed"] == 10          # 13, at most attempted
    assert out["metrics"] == ranks[0]["metrics"]
    assert out["breakdown"] == ranks[0]["breakdown"]
    dev = out["device"]
    assert dev["count"] == 4
    assert dev["memory_peak_bytes"] == 9_000
    assert dev["memory_peak_bytes_by_card"] == [5_000, 9_000, 7_000, 1_000]
    assert dev["power_limit_w"] == 650.0
    assert dev["busy_s"] == pytest.approx(1.25)
    assert dev["window_s"] == pytest.approx(2.0)
    assert dev["busy_s_by_card"] == [1.0, 1.5, 0.5, 2.0]
    assert dev["collective_s_by_card"] == [0.25, 0.5, 0.0, 0.75]
    by_rank = out["info"]["by_rank"]
    assert [b["metrics"]["step_ms"] for b in by_rank] == [5.0, 6.0, 7.0, 8.0]
    assert [b["failed"] for b in by_rank] == [3, 4, 6, 0]
    assert [b["info"]["rank_info"] for b in by_rank] == [0, 1, 2, 3]
    assert len({b["pci_bus_id"] for b in by_rank}) == 4
    assert out["info"]["rank_info"] == 0
    assert list(out)[-1] == "checks"
    # Untraced: no busy seconds on any card, none in the line.
    out = harness.merge_results([_rank(0), _rank(1)])
    assert "busy_s" not in out["device"] and "breakdown" not in out


def _launch(workload, *extra, seconds="0.5", trace="0"):
    t = time.monotonic()
    p = subprocess.Popen(
        [sys.executable, CPU_RANKS, "--bench", FIXTURE, "--workload",
         workload, "--seed", "2200000041", "--seconds", seconds, "--trace",
         trace, *extra], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out, err = p.communicate(timeout=TIMEOUT_S)
    finally:
        p.kill()
    return p.returncode, out, err, time.monotonic() - t


def _pids(err):
    return [int(line.rsplit(" ", 1)[1]) for line in err.splitlines()
            if line.startswith("splatbench: rank ") and ", pid " in line]


def _running(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_two_ranks_print_one_merged_line():
    rc, out, err, _ = _launch("collectives2")
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["correct"] is True, res["checks"]
    dev = res["device"]
    assert dev["count"] == 2 and dev["platform"] == "cpu"
    assert len(dev["memory_peak_bytes_by_card"]) == 2
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_by_card"])
    by_rank = res["info"]["by_rank"]
    assert [b["info"]["gsplat_process_id"] for b in by_rank] == ["0", "1"]
    assert [b["info"]["backend"] for b in by_rank] == ["gloo", "gloo"]
    # Both ranks ran the same rounds: rank 0's flag ends the window.
    assert by_rank[0]["attempted"] == by_rank[1]["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "round_ms"}
    assert res["metrics"]["round_ms"]["value"] == \
        by_rank[0]["metrics"]["round_ms"]
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
    assert not any(_running(pid) for pid in _pids(err))


def test_a_traced_run_reads_every_ranks_reading():
    rc, out, err, _ = _launch("collectives2", trace="1")
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"round_ms.slowest"}
    assert res["metrics"]["round_ms.slowest"]["value"] > 0
    dev = res["device"]
    assert len(dev["busy_s_by_card"]) == 2 and "window_s" in dev
    assert dev["collective_s_by_card"] == [0.0, 0.0]   # no CUDA kernels
    assert "breakdown" in res


def test_a_reader_that_loads_jax_fails_the_run():
    # The gate looks at rank 0's modules after the per-layer readers ran.
    rc, out, err, _ = _launch("collectives2-jax-reader", trace="1")
    assert rc == 4, err[-3000:]
    assert "{" not in out
    assert "JAX or the JAX package is loaded: ['jax']" in err


def test_one_rank_out_of_its_limit_fails_the_run():
    rc, out, err, _ = _launch("collectives2", "--fault", "answer")
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["checks"]["allreduce_err"]["value"] == 0.5
    assert [b["checks"]["allreduce_err"]
            for b in res["info"]["by_rank"]] == [0.0, 0.5]


@pytest.mark.parametrize("workload", ["collectives2-rank1-exits",
                                      "collectives2-rank1-killed",
                                      "collectives2-rank0-exits"])
def test_a_rank_that_ends_ends_the_run(workload):
    rc, out, err, seconds = _launch(workload, seconds="30")
    assert rc != 0
    assert seconds < 60
    assert "{" not in out
    pids = _pids(err)
    assert len(pids) == 1
    deadline = time.monotonic() + 10
    while _running(pids[0]) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _running(pids[0])
