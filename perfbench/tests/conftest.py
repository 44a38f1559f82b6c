"""A tiny copy of the benchmark for the CPU rehearsal tests: the same
files, with the search configurations cut to 16,384 rows of 64
dimensions and their traffic to small batches, and the generation
configurations on the smoke decoder (``checkpoints/decoder_smoke.npz``)
with prompts that fit it."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = {"rows": 16384, "dim": 64, "nlist": 16, "nprobe": 4,
        "check_queries": 512, "check_rows": 2048}
SMOKE = "checkpoints/decoder_smoke.npz"
# the smoke decoder's prefix is 144 tokens, its answer budget 48
TINY_PROMPTS = {"pool": 64, "prompt_len": [48, 144], "question_len": [4, 12],
                "max_tokens": 48}


def tiny_generate(cfg: dict) -> None:
    """A generation configuration on the smoke decoder, with its widths."""
    import numpy as np
    with np.load(REPO / SMOKE) as z:
        cfg.update({k[len("__cfg_"):]: int(z[k]) for k in z
                    if k.startswith("__cfg_")})
    cfg.update(checkpoint=SMOKE, check_requests=8)
    # the smoke decoder's own readings on the CPU (12 sound seeds against
    # 5 of the fp8 control): logit_gap 0.0169-0.0252 against 0.209-0.241,
    # token_deficit 0-0.0070 against 0.0595-0.291
    cfg["limits"].update(logit_gap=0.08, token_deficit=0.03)


def make_tiny(dst: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst)
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dst / "perfbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        if cfg.get("kind") == "generate":
            tiny_generate(cfg)
            f.write_text(json.dumps(cfg))
            continue
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
    # the program's checkpoint beside the benchmark, as in a checkout
    (dst / SMOKE).parent.mkdir(exist_ok=True)
    shutil.copy(REPO / SMOKE, dst / SMOKE)
    f = dst / "perfbench" / "traffic" / "rag1.json"
    f.write_text(json.dumps(dict(json.loads(f.read_text()), **TINY_PROMPTS)))
    return dst


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("bench"))
