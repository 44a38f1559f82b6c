"""The plain reference: top-k search written out in plain PyTorch.

It imports nothing of the port and takes none of its weights, scales or
tables, with one exception named below. The benchmark hands it the same
seed-made corpus and queries that it hands the program.

- ``Reference.scan``: one pass over the corpus, regenerated block by
  block from the seed. It keeps the exact f32 top-k of the query pool
  (the ground truth of ``recall_at_10``; TF32 off) and the corpus
  quantized as the configuration states (int8, the configuration's
  ``scale``).
- ``Reference.scores``: the score a served (query, row) pair must carry:
  the exact int8 dot of the query and the row, both quantized as the
  configuration states, times the two scales.
- ``Reference.probe_topk``: the exact int8 top-k of each query over the
  rows of the lists it probes (for product-quantized lists, over the
  rows that the product-quantized scores put first). Routing (the
  ``nprobe`` lists of largest dot with the centroids) and the dispatch
  capacity (a list takes the first ``qcap`` queries of a batch that
  probe it; later probes are dropped) are written out here, but the centroids, the rows of each
  list and, for product-quantized lists, the codebook and the codes are
  the program's own index: the reference follows the program from its
  built state. The build that this skips is checked by itself
  (``compare.build_checks``).
- ``int4_topk``: the control, the exact scan put in the program's place
  at int4 (per-row symmetric scales), the precision below int8.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.corpus import Docwalk

NEG_INF = float("-inf")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def int8_rows(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric int8 with a fixed scale (rows are unit vectors)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_queries(q: np.ndarray, cfg: dict) -> tuple[np.ndarray, float]:
    """``(int8 [B, d], scale)`` of one batch as the configuration states:
    ``fixed`` takes the configuration's scale, ``batch`` the batch's
    absolute maximum over 127."""
    if cfg["query_quant"] == "fixed":
        s = float(np.float32(cfg["scale"]))
    else:
        s = float(np.abs(q).max()) / 127.0 or 1.0
    return np.clip(np.round(q / np.float32(s)), -127, 127).astype(
        np.int8), s


def score_scale(s_q: float, s_x: float) -> float:
    return float(np.float32(s_q) * np.float32(s_x))


def default_qcap(q_n: int, nprobe: int, nlist: int) -> int:
    """A list's query slots a batch: twice the mean probes a list,
    rounded up to 8, at least 8."""
    return max(8, -(-(q_n * nprobe * 2) // nlist // 8) * 8)


def route(q32: torch.Tensor, centroids: torch.Tensor, nprobe: int
          ) -> torch.Tensor:
    """``[B, nprobe]`` lists of largest dot, ties to the lower list."""
    order = torch.sort(q32 @ centroids.T, dim=1, descending=True,
                       stable=True).indices
    return order[:, :nprobe]


def kept_probes(probes: torch.Tensor, qcap: int) -> torch.Tensor:
    """``[B, nprobe]`` bool: a probe keeps its slot when fewer than
    ``qcap`` earlier queries of the batch probe the same list."""
    flat = probes.reshape(-1)
    lists, order = torch.sort(flat, stable=True)
    first = torch.searchsorted(lists, lists)
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(len(flat), device=flat.device) - first
    return (rank < qcap).view(probes.shape)


class Reference:
    """The reference of one run: ground truth of the pool and the
    corpus quantized as the configuration states, on ``device``."""

    def __init__(self, cfg: dict, corpus: Docwalk):
        self.cfg = cfg
        self.corpus = corpus
        self.k = cfg["k"]
        self.rows8: torch.Tensor | None = None
        self.truth: np.ndarray | None = None

    def scan(self, pool: np.ndarray, q_chunk: int = 2048) -> None:
        """One pass: the pool's exact f32 top-k (row ids, host) and the
        int8 corpus (device)."""
        no_tf32()
        dev = self.corpus.device
        c = self.corpus
        q = torch.as_tensor(pool, device=dev)
        best_v = torch.full((len(q), self.k), NEG_INF, device=dev)
        best_i = torch.full((len(q), self.k), -1, dtype=torch.int64,
                            device=dev)
        self.rows8 = torch.empty((c.n, c.d), dtype=torch.int8, device=dev)
        for lo, hi, x in c.blocks():
            self.rows8[lo:hi] = int8_rows(x, self.cfg["scale"])
            for a in range(0, len(q), q_chunk):
                v, i = torch.topk(q[a:a + q_chunk] @ x.T,
                                  min(self.k, hi - lo), dim=1)
                v = torch.cat([best_v[a:a + q_chunk], v], dim=1)
                i = torch.cat([best_i[a:a + q_chunk], i + lo], dim=1)
                top = torch.topk(v, self.k, dim=1)
                best_v[a:a + q_chunk] = top.values
                best_i[a:a + q_chunk] = torch.gather(i, 1, top.indices)
            del x
        self.truth = best_i.cpu().numpy()

    def scores(self, q8: torch.Tensor, s_scale: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
        """Reference scores ``[S, k]`` of rows ``[S, k]`` (ids in range)
        for queries ``q8 [S, d]`` with score scales ``s_scale [S]``."""
        x = self.rows8[rows.clamp(0, self.corpus.n - 1)].float()
        dots = torch.einsum("sd,skd->sk", q8.float(), x)
        return dots * s_scale[:, None]

    def probe_topk(self, q8: torch.Tensor, s_scale: torch.Tensor,
                   probes: torch.Tensor, kept: torch.Tensor,
                   list_rows: torch.Tensor, tail_rows: torch.Tensor,
                   adc: dict | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact int8 top-k ``(values [S, k], rows [S, k])`` of each query
        over the rows of its kept probed lists and the tail rows.
        ``list_rows [nlist, cap]`` holds each list's row ids (-1 empty).

        With ``adc`` (``codebook [m, K, dsub]``, ``codes [nlist, cap,
        m]``, ``candidates`` C, ``q32 [S, d]``) the list rows first pass
        the product-quantized stage: each row is scored by the query's
        dot with its reconstruction (its list's centroid ``centroids``
        plus its decoded codes), the C best of a query's lists go on, and
        the int8 top-k is taken among those C."""
        dev = q8.device
        k = self.k if adc is None else adc["candidates"]
        s_n, nprobe = probes.shape
        cand_v = torch.full((s_n, nprobe, k), NEG_INF, device=dev)
        cand_r = torch.full((s_n, nprobe, k), -1, dtype=torch.int64,
                            device=dev)
        qf = q8.float() if adc is None else adc["q32"]
        s_idx, j_idx = (t.cpu().numpy() for t in torch.nonzero(
            kept, as_tuple=True))
        lists = probes.cpu().numpy()[s_idx, j_idx]
        order = np.argsort(lists, kind="stable")
        lists, s_idx, j_idx = lists[order], s_idx[order], j_idx[order]
        cuts = np.flatnonzero(np.diff(lists)) + 1
        s_all = torch.as_tensor(s_idx, device=dev)
        j_all = torch.as_tensor(j_idx, device=dev)
        for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(lists)]):
            li = int(lists[lo])
            ids = list_rows[li].long()
            if adc is None:
                x = self.rows8[ids.clamp(min=0)].float()
            else:
                x = adc["centroids"][li] + decode(adc["codebook"],
                                                  adc["codes"][li])
            s, j = s_all[lo:hi], j_all[lo:hi]
            sc = (qf[s] @ x.T).masked_fill(ids[None, :] < 0, NEG_INF)
            kk = min(k, len(ids))
            v, pos = torch.topk(sc, kk, dim=1)
            cand_v[s, j, :kk] = v if adc else v * s_scale[s][:, None]
            cand_r[s, j, :kk] = torch.where(torch.isfinite(v), ids[pos],
                                            torch.full_like(pos, -1))
        top = torch.topk(cand_v.reshape(s_n, -1), k, dim=1)
        rows = torch.gather(cand_r.reshape(s_n, -1), 1, top.indices)
        vals = top.values
        if adc is not None:
            vals = torch.where(rows >= 0, self.scores(q8, s_scale, rows),
                               torch.full_like(vals, NEG_INF))
        if len(tail_rows):
            vals = torch.cat([vals, self.scores(
                q8, s_scale, tail_rows[None, :].expand(s_n, -1))], dim=1)
            rows = torch.cat([rows, tail_rows[None, :].expand(s_n, -1)],
                             dim=1)
        top = torch.topk(vals, self.k, dim=1)
        return top.values, torch.gather(rows, 1, top.indices)


def decode(codebook: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Rows ``[N, m * dsub]`` f32 of codes ``[N, m]``: each subspace's
    codeword, side by side."""
    m = codebook.shape[0]
    sub = torch.arange(m, device=codes.device)
    return codebook[sub[None, :], codes.long()].reshape(len(codes), -1)


def int4_topk(corpus: Docwalk, queries: np.ndarray, k: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """The control: the exact top-k of ``queries`` over the corpus at
    int4, rows and queries each with its own symmetric scale (absolute
    maximum over 7). Returns host (values [S, k], row ids [S, k])."""
    no_tf32()
    dev = corpus.device

    def int4(v):
        s = v.abs().amax(dim=1, keepdim=True) / 7.0
        return torch.clamp(torch.round(v / s), -7, 7), s

    q4, sq = int4(torch.as_tensor(queries, device=dev))
    best_v = torch.full((len(q4), k), NEG_INF, device=dev)
    best_i = torch.full((len(q4), k), -1, dtype=torch.int64, device=dev)
    for lo, hi, x in corpus.blocks():
        x4, sx = int4(x)
        v, i = torch.topk((q4 @ x4.T) * sq * sx.T, min(k, hi - lo), dim=1)
        v = torch.cat([best_v, v], dim=1)
        i = torch.cat([best_i, i + lo], dim=1)
        top = torch.topk(v, k, dim=1)
        best_v, best_i = top.values, torch.gather(i, 1, top.indices)
    return best_v.cpu().numpy(), best_i.cpu().numpy()
