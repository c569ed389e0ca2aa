"""Plain PyTorch versions of the port's kernels: the ground truth the CUDA
kernels are held against on the card, and what a kernel call computes for
tensors on the CPU. Each mirrors its oracle in `repro.kernels.ref`."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def paged_decode_ref(q, k_pages, v_pages, block_table, seq_lens) -> torch.Tensor:
    """Decode attention over a paged KV cache.
    q: (B,H,hd); k_pages/v_pages: (P,page,K,hd); block_table: (B,npages)
    int32 — entries at or beyond a sequence's live page count
    ceil(seq_len / page) are NEVER dereferenced and may hold arbitrary
    garbage; seq_lens: (B,) valid token counts, >= 1. fp32 softmax; the
    probabilities are cast to v's dtype before the PV product, as the JAX
    oracle does (`src/repro/kernels/ref.py:57`)."""
    B, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    npages = block_table.shape[1]
    G = H // K
    T = npages * page
    lens = seq_lens.long()[:, None]                               # (B,1)
    # entries past the ragged edge may be garbage: squash them onto page 0
    # before the gather (their columns are masked anyway)
    live = torch.arange(npages, device=q.device)[None, :] * page < lens
    bt = torch.where(live, block_table.long(), 0)
    k = k_pages[bt].reshape(B, T, K, hd)
    v = v_pages[bt].reshape(B, T, K, hd)
    qg = q.reshape(B, K, G, hd)
    logits = torch.einsum("bkgh,btkh->bkgt", qg, k).float() * hd ** -0.5
    valid = torch.arange(T, device=q.device)[None, :] < lens      # (B,T)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", probs, v)
    return out.reshape(B, H, hd)


def page_gather_ref(pool, ids) -> torch.Tensor:
    """pool: (L, P, page, K, hd); ids: (N,) int32 page slots. Returns the
    dense page stack (N, L, page, K, hd), a new tensor."""
    return pool[:, ids.long()].transpose(0, 1).contiguous()


def page_scatter_ref(pool, staged, ids) -> torch.Tensor:
    """Inverse of `page_gather_ref`: write `staged` (N, L, page, K, hd) into
    the pool at page slots `ids` (unique), IN PLACE. Returns `pool`."""
    pool[:, ids.long()] = staged.transpose(0, 1).to(pool.dtype)
    return pool
