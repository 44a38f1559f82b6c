"""The frozen yardstick: published H100 peaks and the least time of each
list scan's work, counted from what the inputs need.

The peaks are copied from ``rag_foundation_tpu_torch/utils/roofline.py``
(NVIDIA's H100 SXM data sheet; shared memory from the Hopper
architecture paper), not imported, so a change to the program cannot
move them. The counts do not follow the program's layout (its query
slots, ``qcap``, its top-p outputs): a batch needs the live rows of
every list its queries probe, each read once with its row id, and its
query rows (or tables) read once; its operations are one score for each
(query, live row of a probed list) pair. A share is that least time
over the kernel's measured time; it cannot pass 100 % unless the work
is counted too high or the time misses part of the work.

A generation cell's model operations (``<flops>_flops(cfg, prompt_len,
new_tokens)``, named by its configuration's ``flops``) count what a
request needs: its prompt and every answer token but the last run
through the model once, each position attending over the real context
before it (causally, no padding), and the output head where a token is
chosen. ``gen.mfu`` is their sum over the window's seconds at the bf16
peak.
"""

from __future__ import annotations

import torch

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1.979e15, "bf16": 0.989e15, "f32": 67e12}
# 128 bytes per SM per clock, 132 SMs at the 1.98 GHz boost clock
SMEM_BYTES_S = 132 * 128 * 1.98e9
ID_BYTES = 4


def probed_work(probes: torch.Tensor, live: torch.Tensor
                ) -> tuple[int, int]:
    """``(rows of the lists probed, (query, row) pairs)`` of one batch:
    ``probes [Q, nprobe]`` list ids, ``live [nlist]`` live rows a list.
    A list probed by several queries is read once."""
    lists = torch.unique(probes)
    return int(live[lists].sum()), int(live[probes].sum())


def flat_scan_s(q_n: int, d: int, esize: int, kind: str, list_rows: int,
                pairs: int) -> float:
    """Least seconds of a flat list scan: the rows and their ids read
    once, the ``q_n`` query rows read once; ``2 d`` operations a pair at
    the type's peak."""
    nbytes = list_rows * (d * esize + ID_BYTES) + q_n * d * esize
    return max(nbytes / HBM_BYTES_S, 2.0 * d * pairs / PEAK_OPS_S[kind])


def adc_scan_s(q_n: int, m: int, m_bytes: int, k_codes: int,
               lut_esize: int, list_rows: int, pairs: int) -> float:
    """Least seconds of an ADC list scan: the rows' codes (``m_bytes``
    a row) and ids read once, each query's table (``k_codes`` x ``m``
    entries) read once; ``m`` table lookups a pair, each one entry from
    shared memory at ``SMEM_BYTES_S``."""
    nbytes = list_rows * (m_bytes + ID_BYTES) + q_n * k_codes * m * lut_esize
    return max(nbytes / HBM_BYTES_S, m * pairs * lut_esize / SMEM_BYTES_S)


def prefix_lm_flops(cfg: dict, prompt_len: int, new_tokens: int) -> float:
    """Operations of one answer of ``new_tokens`` to a prompt of
    ``prompt_len`` on the GPT-style decoder of ``cfg``'s widths (``hidden``
    h, ``layers``, ``ffn``, ``vocab_size`` V): ``T = prompt_len +
    new_tokens - 1`` positions run, each ``2 h (3h + h + 2 ffn)`` of
    products a layer and ``4 h (p + 1)`` of attention at position ``p``
    (Q.K and P.V); the tied output head ``2 h V`` for each answer token."""
    h, ffn = cfg["hidden"], cfg["ffn"]
    t = prompt_len + new_tokens - 1
    per_layer = t * 2 * h * (4 * h + 2 * ffn) + 4 * h * t * (t + 1) / 2
    return cfg["layers"] * per_layer + new_tokens * 2 * h * cfg["vocab_size"]
