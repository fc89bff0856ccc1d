"""Plain PyTorch versions of the port's kernels.

They define the arithmetic the CUDA kernels must match: every input is
upcast to float32 and every reduction accumulates in float32.  The kernel
wrappers (:mod:`repro_torch.kernels.ss_weights`, ``feature_gains``,
``fl_divergence``, ``fl_stream``, ``flash_attention``) run them for tensors
on the CPU; on the card they serve only as the comparison in
``chip_smoke.py``.

All of them walk the candidates in chunks and the probes one at a time, so
the textbook formulas' blocks never exist: the (r, n, F) block of
FeatureCoverage (a single (n, F) float32 temporary is already 4 GiB at
n = 2^20, F = 1024), and the (r, n, n) hinge block of facility location, or
in the matrix-free case even the (n, n) similarity.  Attention walks blocks
of query rows, so its (B, H, S, S) score block never exists either.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

INF = 1e30
NEG = -INF

PHI_KINDS = ("sqrt", "log1p", "setcover", "satcov", "linear")

# Candidate rows per chunk: bounds each (rows, F) float32 temporary to
# 256 MiB at F = 1024.
_ROW_CHUNK = 1 << 16
# Elements per float32 temporary of the facility-location paths (256 MiB).
_ELEMS = 1 << 26


def _phi(kind: str, c: Tensor, cap: Tensor | None) -> Tensor:
    """Concave scalar transforms phi(c), elementwise."""
    if kind == "sqrt":
        return torch.sqrt(torch.clamp_min(c, 0.0))
    if kind == "log1p":
        return torch.log1p(torch.clamp_min(c, 0.0))
    if kind == "setcover":
        return torch.clamp_max(c, 1.0)
    if kind == "satcov":
        if cap is None:
            raise ValueError("phi='satcov' needs a cap vector")
        return torch.minimum(c, cap)
    if kind == "linear":
        return c
    raise ValueError(f"unknown concave transform {kind!r}")


def _rows(W: Tensor, cand_idx: Tensor | None, lo: int, hi: int) -> Tensor:
    rows = W[lo:hi] if cand_idx is None else W[cand_idx[lo:hi]]
    return rows.float()


def ss_divergence_ref(
    W: Tensor,             # (n, F) candidate feature rows
    CU: Tensor,            # (r, F) probe coverage rows (state + W[probe])
    phi_cu: Tensor,        # (r,) sum_f w_f phi(CU); -INF marks a pad probe
    resid: Tensor,         # (r,) residual gains f(u | V \\ u)
    cap: Tensor | None = None,     # (F,) satcov caps
    phi: str = "sqrt",
    feat_w: Tensor | None = None,  # (F,) feature weights
    cand_idx: Tensor | None = None,  # (k,) rows of W to evaluate
) -> Tensor:
    """w_v = min_u [sum_f w_f phi(CU_u + W_v) - phi_cu_u - resid_u].

    Shape (n,), or (k,) with ``cand_idx``.  A pad probe (phi_cu = -INF)
    gives +INF and never wins the min.
    """
    CUf = CU.float()
    capf = None if cap is None else cap.float()
    fw = None if feat_w is None else feat_w.float()
    base = phi_cu.float()
    n_out = W.shape[0] if cand_idx is None else cand_idx.shape[0]
    out = torch.empty((n_out,), dtype=torch.float32, device=W.device)
    for lo in range(0, n_out, _ROW_CHUNK):
        hi = min(n_out, lo + _ROW_CHUNK)
        rows = _rows(W, cand_idx, lo, hi)
        best = torch.full((hi - lo,), INF, dtype=torch.float32, device=W.device)
        for u in range(CUf.shape[0]):
            val = _phi(phi, CUf[u] + rows, capf)
            if fw is not None:
                val = val * fw
            w = (val.sum(dim=-1) - base[u]) - resid[u].float()
            best = torch.minimum(best, w)
        out[lo:hi] = best
    return out


def feature_gains_ref(
    W: Tensor,            # (n, F)
    c: Tensor,            # (F,) current coverage state
    phi_c: Tensor,        # scalar: sum_f w_f phi(c)
    cap: Tensor | None = None,
    phi: str = "sqrt",
    feat_w: Tensor | None = None,
    cand_idx: Tensor | None = None,
) -> Tensor:
    """g_v = sum_f w_f phi(c + W_v) - phi_c.  Shape (n,), or (k,)."""
    cf = c.float()
    capf = None if cap is None else cap.float()
    fw = None if feat_w is None else feat_w.float()
    n_out = W.shape[0] if cand_idx is None else cand_idx.shape[0]
    out = torch.empty((n_out,), dtype=torch.float32, device=W.device)
    for lo in range(0, n_out, _ROW_CHUNK):
        hi = min(n_out, lo + _ROW_CHUNK)
        val = _phi(phi, cf + _rows(W, cand_idx, lo, hi), capf)
        if fw is not None:
            val = val * fw
        out[lo:hi] = val.sum(dim=-1) - phi_c.float()
    return out


# -- facility location -------------------------------------------------------


def matmul_ieee(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in IEEE float32.  TF32 would change which candidates
    survive SS, so a CUDA product with TF32 enabled raises instead."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the facility-location "
            "similarities must be computed in IEEE float32"
        )
    return a.float() @ b.float()


def sim_rows(X: Tensor, Xc: Tensor) -> Tensor:
    """The similarity block relu(X @ Xcᵀ): rows of X served by rows of Xc."""
    return torch.clamp_min_(matmul_ieee(X, Xc.T), 0.0)


def top2(rows: Tensor) -> tuple[Tensor, Tensor]:
    """The two largest values of each row (best, second), as ``lax.top_k``
    gives them: equal maxima give best == second, and a single column gives
    second = NEG."""
    if rows.shape[1] >= 2:
        t = torch.topk(rows, 2, dim=1).values
        return t[:, 0], t[:, 1]
    return rows[:, 0], torch.full_like(rows[:, 0], NEG)


def fl_residuals(row_blocks, n: int, device) -> Tensor:
    """f(v | V \\ v) of facility location from blocks of served rows of the
    similarity, each (rows, n).  Only rows where v is the unique argmax
    lose, dropping to their second best; a row whose best is reached by
    more than one column loses nothing."""
    out = torch.zeros((n,), dtype=torch.float32, device=device)
    for blk in row_blocks:
        blk = blk.float()
        best, second = top2(blk)
        is_best = blk >= best[:, None]
        tie = is_best.sum(dim=1) > 1
        loss = torch.where(tie, 0.0, best.clamp_min(0.0) - second.clamp_min(0.0))
        out += torch.where(is_best, loss[:, None], 0.0).sum(dim=0)
    return out


def _fl_walk(cols_of, n_out: int, MU: Tensor, resid: Tensor | None) -> Tensor:
    """The hinge sums acc[u, v] = sum_i max(cols[i, v] - MU[u, i], 0) over
    candidate chunks ``cols_of(lo, hi)`` (ni, hi - lo) of at most 256 MiB,
    one probe at a time.  Returns acc (r, n_out), or with ``resid`` its min
    over probes of acc - resid (n_out,)."""
    MUf = MU.float()
    r, ni = MUf.shape
    chunk = max(1, _ELEMS // max(1, ni))
    shape = (n_out,) if resid is not None else (r, n_out)
    out = torch.empty(shape, dtype=torch.float32, device=MU.device)
    for lo in range(0, n_out, chunk):
        hi = min(n_out, lo + chunk)
        cols = cols_of(lo, hi)
        best = torch.full((hi - lo,), INF, dtype=torch.float32, device=MU.device)
        for u in range(r):
            acc = (cols - MUf[u, :, None]).clamp_min_(0.0).sum(dim=0)
            if resid is None:
                out[u, lo:hi] = acc
            else:
                best = torch.minimum(best, acc - resid[u].float())
        if resid is not None:
            out[lo:hi] = best
    return out


def _cols_dense(sim: Tensor, cand_idx: Tensor | None):
    if cand_idx is None:
        return lambda lo, hi: sim[:, lo:hi].float()
    return lambda lo, hi: sim[:, cand_idx[lo:hi]].float()


def fl_pair_ref(sim: Tensor, MU: Tensor, cand_idx: Tensor | None = None) -> Tensor:
    """acc[u, v] = sum_i max(sim[i, v] - MU[u, i], 0).  Shape (r, n) or (r, k);
    candidates are *columns* of ``sim``."""
    n_out = sim.shape[1] if cand_idx is None else cand_idx.shape[0]
    return _fl_walk(_cols_dense(sim, cand_idx), n_out, MU, None)


def fl_divergence_ref(
    sim: Tensor,       # (ni, n) similarity; sim[i, v] = service of row i by v
    MU: Tensor,        # (r, ni) probe coverage rows max(state, sim[:, u])
    resid: Tensor,     # (r,) residual gains; -INF marks a pad probe
    cand_idx: Tensor | None = None,  # (k,) columns of sim to evaluate
) -> Tensor:
    """w_v = min_u [sum_i max(sim[i, v] - MU[u, i], 0) - resid_u].

    Shape (n,), or (k,) with ``cand_idx``.  The hinge terms are summed
    directly, never as sum_i max(sim, MU) - sum_i MU, which would lose the
    small gaps between candidates to float32 cancellation.
    """
    n_out = sim.shape[1] if cand_idx is None else cand_idx.shape[0]
    return _fl_walk(_cols_dense(sim, cand_idx), n_out, MU, resid)


def _cols_stream(X: Tensor, Xc: Tensor | None, cand_idx: Tensor | None):
    Xc = X if Xc is None else Xc
    if cand_idx is None:
        return lambda lo, hi: sim_rows(X, Xc[lo:hi])
    return lambda lo, hi: sim_rows(X, Xc[cand_idx[lo:hi]])


def _n_cand(X: Tensor, Xc: Tensor | None, cand_idx: Tensor | None) -> int:
    if cand_idx is not None:
        return cand_idx.shape[0]
    return (X if Xc is None else Xc).shape[0]


def fl_stream_pair_ref(
    X: Tensor,                        # (ni, d) served rows
    MU: Tensor,                       # (r, ni) probe coverage rows
    cand_idx: Tensor | None = None,   # (k,) rows of Xc to evaluate
    Xc: Tensor | None = None,         # (n, d) candidate rows; None = X
) -> Tensor:
    """acc[u, v] = sum_i max(relu(x_i . xc_v) - MU[u, i], 0).  Shape (r, n)
    or (r, k).  Similarity columns are computed a chunk at a time; the
    (ni, n) matrix never exists."""
    return _fl_walk(_cols_stream(X, Xc, cand_idx), _n_cand(X, Xc, cand_idx),
                    MU, None)


def fl_stream_divergence_ref(
    X: Tensor,
    MU: Tensor,
    resid: Tensor,     # (r,); -INF marks a pad probe
    cand_idx: Tensor | None = None,
    Xc: Tensor | None = None,
) -> Tensor:
    """w_v = min_u [acc[u, v] - resid_u] over relu(X · Xcᵀ).  (n,) or (k,)."""
    return _fl_walk(_cols_stream(X, Xc, cand_idx), _n_cand(X, Xc, cand_idx),
                    MU, resid)


# -- attention ---------------------------------------------------------------


def _softcap(s: Tensor, cap: float) -> Tensor:
    return s if cap <= 0.0 else cap * torch.tanh(s / cap)


def attention_ref(
    q: Tensor,             # (B, S, H, hd)
    k: Tensor,             # (B, S, KV, hd), H a multiple of KV
    v: Tensor,             # (B, S, KV, hd)
    causal: bool = True,
    window: int = 0,       # > 0: sliding window (causal only)
    softcap: float = 0.0,  # > 0: cap * tanh(s / cap) on the scores
) -> Tensor:
    """Softmax attention with grouped KV heads: query head h reads KV head
    h // (H / KV) in place.  Float32 math, the result in q's dtype.

    The function the flash kernel computes: softmax(mask(QKᵀ/√hd))·V, with
    the causal mask qpos >= kpos, the window qpos - kpos < window (causal
    only) and no mask at all when not causal.  It walks blocks of query
    rows, each against only the keys its mask can reach, so a score block
    stays under 256 MiB (``_ELEMS`` float32) at any S.
    """
    def pv(s: Tensor, vb: Tensor) -> Tensor:
        return torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), vb)

    return _attention_blocks(q, k, v, causal, window, softcap, pv)


def split_bf16(p: Tensor, parts: int) -> list[Tensor]:
    """float32 ``p`` as ``parts`` bfloat16 tensors, the plain form of the
    tensor-core flash kernel's split of P: hi = bf16(p), then each next part
    rounds what the earlier ones leave (p - hi, then p - hi - mid).  Each
    subtraction is exact in float32 (the part shares the remainder's leading
    bits), so the parts sum back to p within 2^-(8 parts) |p|: 24 bits, all
    of float32's, at three parts."""
    out, r = [], p.float()
    for _ in range(parts):
        part = r.to(torch.bfloat16)
        out.append(part)
        r = r - part.float()
    return out


def attention_split_p_ref(
    q: Tensor, k: Tensor, v: Tensor, causal: bool = True, window: int = 0,
    parts: int = 3,
) -> Tensor:
    """:func:`attention_ref` with P·V taken over bfloat16 parts of P: with
    p = exp(s - max s) in float32, O = sum over :func:`split_bf16`'s parts
    of (part · V) in float32, over sum p.  At three parts it is the
    tensor-core flash kernel's arithmetic (and the TPU kernel's function);
    ``parts=1`` rounds P to bfloat16 once before P·V, as
    ``scaled_dot_product_attention`` does: a different result, kept here
    only as a yardstick for the tests and ``chip_smoke.py``."""
    def pv(s: Tensor, vb: Tensor) -> Tensor:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = sum(torch.einsum("bkgqs,bskd->bqkgd", part.float(), vb)
                for part in split_bf16(p, parts))
        return o / p.sum(-1).permute(0, 3, 1, 2)[..., None]

    return _attention_blocks(q, k, v, causal, window, 0.0, pv)


def _attention_blocks(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                      window: int, softcap: float, pv) -> Tensor:
    """The block walk of the attention functions above: masked scores
    (B, KV, G, rows, keys) of each block of query rows, turned into the
    block's output (B, rows, KV, G, hd) by ``pv(scores, v block)``."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    rows = max(1, _ELEMS // (B * H * S))
    for lo in range(0, S, rows):
        hi = min(S, lo + rows)
        k_lo, k_hi = 0, S
        if causal:
            k_hi = hi
            if window > 0:
                k_lo = max(0, lo - window + 1)
        qb = q[:, lo:hi].float().reshape(B, hi - lo, KV, G, hd)
        s = torch.einsum("bqkgd,bskd->bkgqs", qb, kf[:, k_lo:k_hi]) * scale
        s = _softcap(s, softcap)
        if causal:
            dq = (torch.arange(lo, hi, device=q.device)[:, None]
                  - torch.arange(k_lo, k_hi, device=q.device)[None, :])
            mask = dq >= 0
            if window > 0:
                mask &= dq < window
            s = torch.where(mask, s, NEG)
        o = pv(s, vf[:, k_lo:k_hi])
        out[:, lo:hi] = o.reshape(B, hi - lo, H, hd).to(q.dtype)
    return out


def flash_attention_ref(
    q: Tensor, k: Tensor, v: Tensor, causal: bool = True, window: int = 0
) -> Tensor:
    """Plain version of the flash-attention kernel on its TPU layout:
    (BH, S, hd) each, batch and heads flattened, k and v already expanded
    to the query heads.  Returns (BH, S, hd) in q's dtype."""
    return attention_ref(q[:, :, None], k[:, :, None], v[:, :, None],
                         causal, window)[:, :, 0]
