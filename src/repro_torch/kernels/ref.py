"""Plain PyTorch versions of the port's kernels: the ground truth the CUDA
kernels are held against on the card, and what a kernel call computes for
tensors on the CPU. Each mirrors its oracle in `repro.kernels.ref`."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Dense GQA attention (the prefill form).
    q: (B,H,S,hd); k/v: (B,K,T,hd) with H % K == 0, query head h reading
    KV head h // (H//K). With `causal`, row s sees columns t <= s: the
    absolute mask, with no offset when S != T. fp32 softmax; the
    probabilities are cast to v's dtype before the PV product, as the JAX
    oracle does (`src/repro/kernels/ref.py:9-23`)."""
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, S, hd)
    logits = torch.einsum("bkgsh,bkth->bkgst", qg, k).float() * hd ** -0.5
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,bkth->bkgsh", probs, v)
    return out.reshape(B, H, S, hd)


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


def paged_verify_ref(q, k_pages, v_pages, block_table, seq_lens) -> torch.Tensor:
    """Multi-query verify attention over a paged KV cache (speculative
    decoding's target half).
    q: (B,Q,H,hd), the Q candidate positions of each sequence, whose K/V
    the caller has already written into the pool; seq_lens: (B,) TOTAL
    valid token counts INCLUDING the Q candidates (>= Q). Query qi attends
    positions < seq_len - Q + qi + 1 (itself and everything before it, none
    of the later candidates). Same garbage-past-ragged-edge block-table
    contract as `paged_decode_ref`, whose math it reduces to at Q=1; fp32
    softmax, probabilities cast to v's dtype before PV
    (`src/repro/kernels/ref.py:60-95`)."""
    B, Q, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    npages = block_table.shape[1]
    G = H // K
    T = npages * page
    lens = seq_lens.long()[:, None]                               # (B,1)
    live = torch.arange(npages, device=q.device)[None, :] * page < lens
    bt = torch.where(live, block_table.long(), 0)
    k = k_pages[bt].reshape(B, T, K, hd)
    v = v_pages[bt].reshape(B, T, K, hd)
    # fold the query axis into the grouped-query axis: head h = k*G + g,
    # row g*Q + qi of KV head k
    qg = q.transpose(1, 2).reshape(B, K, G * Q, hd)
    logits = torch.einsum("bkrh,btkh->bkrt", qg, k).float() * hd ** -0.5
    qi = torch.arange(G * Q, device=q.device) % Q
    limit = lens - Q + qi[None, :] + 1                            # (B,G*Q)
    valid = torch.arange(T, device=q.device)[None, None, :] < limit[..., None]
    logits = torch.where(valid[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrt,btkh->bkrh", probs, v)
    return out.reshape(B, K, G, Q, hd).permute(0, 3, 1, 2, 4).reshape(
        B, Q, H, hd)


def page_gather_ref(pool, ids) -> torch.Tensor:
    """pool: (L, P, page, K, hd); ids: (N,) int32 page slots. Returns the
    dense page stack (N, L, page, K, hd), a new tensor."""
    return pool[:, ids.long()].transpose(0, 1).contiguous()


def page_scatter_ref(pool, staged, ids) -> torch.Tensor:
    """Inverse of `page_gather_ref`: write `staged` (N, L, page, K, hd) into
    the pool at page slots `ids` (unique), IN PLACE. Returns `pool`."""
    pool[:, ids.long()] = staged.transpose(0, 1).to(pool.dtype)
    return pool


def ssd_scan_ref(x, dt, a, B_, C_, *, chunk: int) -> torch.Tensor:
    """The Mamba2 SSD scan, token by token (zero initial state): the plain
    version of the chunked kernel, which gives the same answer for every
    `chunk` (the argument is the kernel's and is not used here).
    x: (B,H,S,P) f32; dt: (B,H,S) f32 post-softplus; a: (H,) f32 (< 0);
    B_/C_: (B,G,S,N) f32, group g serving heads g*H//G .. (g+1)*H//G - 1.
    Returns y: (B,H,S,P) f32 (`src/repro/kernels/ref.py:98-121`)."""
    Bb, H, S, P = x.shape
    G, N = B_.shape[1], B_.shape[3]
    hpg = H // G
    Bh = B_.repeat_interleave(hpg, dim=1)                   # (B,H,S,N)
    Ch = C_.repeat_interleave(hpg, dim=1)
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dt[:, :, t]
        decay = torch.exp(dtt * a[None, :])
        h = h * decay[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtt, x[:, :, t], Bh[:, :, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, :, t]))
    return torch.stack(ys, dim=2)                            # (B,H,S,P)
