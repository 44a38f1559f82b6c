"""A tiny copy of the benchmark for the CPU rehearsal tests: the same
files, with the configurations cut to 16,384 rows of 64 dimensions and
the traffic to small batches."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = {"rows": 16384, "dim": 64, "nlist": 16, "nprobe": 4,
        "check_queries": 512, "check_rows": 2048}


def make_tiny(dst: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst)
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dst / "perfbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(TINY)
        cfg["corpus"].update(topics=64, block=2048)
        if cfg["mode"] == "ivf_pq":
            cfg["pq_m"] = 16
            # lists of 1,024 rows put a twentieth of a query's 4,096
            # candidates in the ADC top 64 (at 10M, a sixtieth of 78,000):
            # int8 table rounding moves more rows across that edge
            cfg["limits"]["rank_miss"] = 0.05
            # the same edge: recall@10 0.87 here (sound runs' recall_miss
            # 0.115-0.135), 0.99 at 10M
            cfg["limits"]["recall_miss"] = 0.3
        f.write_text(json.dumps(cfg))
    for name, batch in (("q1024", 256), ("q64", 64)):
        f = dst / "perfbench" / "traffic" / f"{name}.json"
        t = json.loads(f.read_text())
        t.update(batch=batch, pool=1024)
        f.write_text(json.dumps(t))
    return dst


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("bench"))
