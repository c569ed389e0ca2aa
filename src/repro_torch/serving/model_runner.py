"""Model steps for the paged serving engine (PyTorch port of
`repro.serving.model_runner`: dense, MoE and early-fusion VLM
transformers).

The KV cache is a PAGED pool shared by all sequences,

    k_pages / v_pages: (L, P, page_size, K, hd)

with per-sequence block tables (one page id list per sequence, shared
across layers); the layer loop carries the L axis. The JAX steps are pure
functions with donated pools; here each step writes the new K/V rows into
the pools in place (`index_put_`) and returns the same tensors, so the
backend threads them through exactly as the JAX backend does.

  `decode_step`  consumes the backend's persistent device-resident batch
      state (block table, seq lens, last tokens, per-row sampling params)
      at its FULL capacity shape and slices the active `(nb, npgb)` bucket,
      writes the new K/V, runs paged attention (`kops.paged_decode`: the
      CUDA kernel for CUDA tensors, its plain version on the CPU), samples
      on device with per-row temperature/top-k, and advances `lens`/`toks`
      in place — sampled tokens stay resident for the next step's
      embedding lookup.

  `prefill_pack_step`  admits SEVERAL sequences at once: their uncached
      suffixes are ragged-packed along one token axis with per-token
      segment ids / positions / page destinations, each segment attending
      to its own radix-cached prefix gathered from a packed past-page list.
      New K/V rows scatter straight into the pool and every segment's
      boundary token is sampled in the same call.

  `prefill_step`  the one-request-at-a-time path (`packed_prefill=False`).

  `spec_decode_step`  draft-k/verify-1 speculation over the same bucketed
      state: k+1 drafter single-token forwards (the last one only writes
      its KV), then ONE multi-query target forward over the k+1 candidate
      positions (`kops.paged_verify`), exact-match acceptance against the
      target's own seed+position draws, and the in-place advance of
      `lens`/`toks` past the accepted run.

Prefill attention is the plain masked `_sdpa`, as the JAX package computes
it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, embed_tokens, lm_logits,
                                      rms_norm)
from repro_torch.models.moe import apply_moe
from repro_torch.models.transformer import layer
from repro_torch.serving.sampling import (fold_in, fold_key,
                                          sample_rows_impl, uniform)


def init_kv_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                 dtype=torch.bfloat16, device="cuda"):
    shp = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return (torch.zeros(shp, dtype=dtype, device=device),
            torch.zeros(shp, dtype=dtype, device=device))


def _ffn(lp, h, cfg: ModelConfig):
    """The FFN of one layer. An MoE layer's groups are the rows of `h`
    as the step shapes it: a packed prefill (1, T_bucket, d) is one group
    whose padding tokens take capacity too, decode (B, 1, d) and verify
    (B, Q, d) one group per sequence, as in the JAX package."""
    if cfg.is_moe:
        return apply_moe(lp["moe"], h, cfg)[0]
    return apply_mlp(lp["mlp"], h, cfg)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul over the flattened heads."""
    H, hd, d = wo.shape
    return o.flatten(-2) @ wo.reshape(H * hd, d)


def _prefill_layers(params, h, positions, mask, past_pages, dest_page,
                    dest_slot, k_pages, v_pages, cfg: ModelConfig):
    """The layer loop both prefill steps share: each layer attends over the
    gathered past pages plus the new rows, then writes the new rows' K/V
    into the pool in place."""
    K, hd = cfg.n_kv_heads, cfg.hd
    for li in range(cfg.n_layers):
        lp = layer(params["layers"], li)
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q = attn._project_q(lp["attn"], x, cfg, positions, rope=True)
        k_new, v_new = attn._project_kv(lp["attn"], x, cfg, positions,
                                        rope=True)
        k_new = k_new.to(k_pages.dtype)
        v_new = v_new.to(v_pages.dtype)
        k_past = k_pages[li][past_pages].reshape(1, -1, K, hd)
        v_past = v_pages[li][past_pages].reshape(1, -1, K, hd)
        k_all = torch.cat([k_past, k_new], dim=1)
        v_all = torch.cat([v_past, v_new], dim=1)
        o = attn._sdpa(q, k_all, v_all, mask, cfg)
        h = h + _out_proj(o, lp["attn"]["wo"])
        h = h + _ffn(lp, rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)
        k_pages[li, dest_page, dest_slot] = k_new[0]
        v_pages[li, dest_page, dest_slot] = v_new[0]
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


# ----------------------------------------------------------------- prefill

@torch.no_grad()
def prefill_step(params: Any, tokens: torch.Tensor, new_pages: torch.Tensor,
                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                 past_pages: torch.Tensor, past_len: int, new_len: int, *,
                 cfg: ModelConfig, page_size: int):
    """One-request prefill over the uncached suffix (sequential path).

    tokens:     (1, S_pad)   uncached suffix, right-padded
    new_pages:  (NP,) int64  page ids to write the suffix K/V into (padded
                             with a scratch page id; the suffix starts at
                             slot 0 of new_pages[0])
    past_pages: (CP,) int64  radix-cached prefix pages (padded w/ scratch)
    past_len:   cached prefix token count
    new_len:    real suffix length (<= S_pad)
    Returns (logits_last (1, vocab), k_pages, v_pages).
    """
    dev = tokens.device
    S = tokens.shape[1]
    h = embed_tokens(params, tokens, cfg)           # compute in param dtype
    rows = torch.arange(S, device=dev)
    positions = (past_len + rows)[None, :]          # (1, S)
    # row i of the suffix scatters straight into page new_pages[i // ps],
    # slot i % ps
    dest_page = new_pages[rows // page_size]
    dest_slot = rows % page_size
    # past cols < past_len valid for all rows; new cols causal & < new_len
    T_past = past_pages.shape[0] * page_size
    m_past = (torch.arange(T_past, device=dev) < past_len).expand(S, T_past)
    m_new = (rows[None, :] <= rows[:, None]) & (rows < new_len)[None, :]
    mask = torch.cat([m_past, m_new], dim=1)[None, None]          # (1,1,S,T)
    h = _prefill_layers(params, h, positions, mask, past_pages, dest_page,
                        dest_slot, k_pages, v_pages, cfg)
    last = min(max(new_len - 1, 0), S - 1)
    logits = lm_logits(params, h[:, last:last + 1], cfg)[:, 0]
    return logits, k_pages, v_pages


@torch.no_grad()
def prefill_pack_step(params: Any, tokens: torch.Tensor, seg_ids: torch.Tensor,
                      positions: torch.Tensor, dest_page: torch.Tensor,
                      dest_slot: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, past_pages: torch.Tensor,
                      past_start: torch.Tensor, past_len: torch.Tensor,
                      last_idx: torch.Tensor, temps: torch.Tensor,
                      top_ks: torch.Tensor, seeds: torch.Tensor,
                      sample_pos: torch.Tensor, base_key: torch.Tensor, *,
                      cfg: ModelConfig, page_size: int):
    """Packed ragged prefill: several sequences' uncached suffixes in ONE
    call, each attending to its own cached prefix; the boundary next token
    of every segment is sampled on device in the same call.

    Packed token axis (S = bucketed total, padding tokens have seg -1):
      tokens / seg_ids / positions / dest_page / dest_slot: (S,)
    Packed past-page axis (CP = bucketed total, padded with scratch):
      past_pages: (CP,)  all segments' cached-prefix pages, packed
    Per segment (NSEG = bucketed count):
      past_start (first past column), past_len, last_idx (packed index of
      the segment's last token), temps/top_ks/seeds/sample_pos
    Returns (tokens (NSEG,) int32, k_pages, v_pages).
    """
    dev = tokens.device
    S = tokens.shape[0]
    nseg = past_start.shape[0]
    h = embed_tokens(params, tokens[None, :], cfg)                # (1,S,d)
    tseg = seg_ids.clamp(0, nseg - 1).long()
    tstart = past_start[tseg]                                     # (S,)
    tplen = past_len[tseg]
    tok_idx = torch.arange(S, device=dev)
    # past col c valid for token t iff it falls in t's segment's window
    past_cols = torch.arange(past_pages.shape[0] * page_size, device=dev)
    m_past = ((past_cols[None, :] >= tstart[:, None]) &
              (past_cols[None, :] < (tstart + tplen)[:, None]))   # (S,Tp)
    # new col u valid for token t iff same segment and causal; this
    # includes every token's own diagonal (padding rows share seg -1), so
    # no row's softmax is ever all-masked
    m_new = ((seg_ids[None, :] == seg_ids[:, None]) &
             (tok_idx[None, :] <= tok_idx[:, None]))
    mask = torch.cat([m_past, m_new], dim=1)[None, None]          # (1,1,S,T)
    h = _prefill_layers(params, h, positions[None, :], mask, past_pages,
                        dest_page, dest_slot, k_pages, v_pages, cfg)
    logits = lm_logits(params, h[:, last_idx.long()], cfg)[0]     # (NSEG,V)
    toks = sample_rows_impl(logits, base_key, seeds, sample_pos, temps,
                            top_ks)
    return toks, k_pages, v_pages


# ------------------------------------------------------------------ decode

def _token_fwd(params, toks, positions, atn_lens, bt, page_ids, offsets,
               k_pages, v_pages, *, cfg: ModelConfig, head: bool = True):
    """One single-token forward for a batch: embed + per-layer KV write at
    (page_ids, offsets) + ragged paged attention over `atn_lens` tokens.
    Returns (logits (B, V), k_pages, v_pages); with `head=False` only the
    KV writes matter and the final norm and vocab projection are skipped
    (logits None), as XLA drops them when the caller ignores the logits."""
    h = embed_tokens(params, toks[:, None], cfg)    # compute in param dtype
    pos2 = positions[:, None]
    for li in range(cfg.n_layers):
        lp = layer(params["layers"], li)
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q = attn._project_q(lp["attn"], x, cfg, pos2, rope=True)
        k_new, v_new = attn._project_kv(lp["attn"], x, cfg, pos2, rope=True)
        k_pages[li, page_ids, offsets] = k_new[:, 0].to(k_pages.dtype)
        v_pages[li, page_ids, offsets] = v_new[:, 0].to(v_pages.dtype)
        o = kops.paged_decode(q[:, 0].contiguous(), k_pages[li], v_pages[li],
                              bt, atn_lens)
        h = h + _out_proj(o, lp["attn"]["wo"])[:, None]
        h = h + _ffn(lp, rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)
    if not head:
        return None, k_pages, v_pages
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h, cfg)[:, 0], k_pages, v_pages


@torch.no_grad()
def decode_step(params: Any, state: dict, k_pages: torch.Tensor,
                v_pages: torch.Tensor, base_key: torch.Tensor, *,
                cfg: ModelConfig, page_size: int, nb: int, npgb: int):
    """Fused continuous-batch decode: embed + forward + KV write + paged
    attention + per-row sampling + state advance.

    `state` is the backend's persistent device-resident batch state at
    full capacity shape (Bcap, NPGcap); the active bucket `(nb, npgb)` is
    sliced here:

      bt:    (Bcap, NPGcap) int32  block tables (scratch-padded)
      lens:  (Bcap,) int32   tokens already in cache per row (0 = inactive
                             padding row; real rows always have lens >= 1)
      toks:  (Bcap,) int32   last sampled token per row (device-resident —
                             the host never uploads tokens on this path)
      temps/top_ks/seeds: (Bcap,) per-row sampling params / RNG ids

    Rows [nb:] are untouched; inactive rows inside the bucket keep lens=0,
    write only to their scratch page, and sample garbage that is ignored.
    `lens`/`toks` advance in place. Returns (tokens (nb,) int32, state,
    k_pages, v_pages).
    """
    bt = state["bt"][:nb, :npgb].contiguous()
    lens = state["lens"][:nb]
    toks = state["toks"][:nb]
    temps = state["temps"][:nb]
    top_ks = state["top_ks"][:nb]
    seeds = state["seeds"][:nb]

    page_ids = bt.gather(1, (lens // page_size).long()[:, None])[:, 0].long()
    offsets = (lens % page_size).long()
    logits, k_pages, v_pages = _token_fwd(
        params, toks, lens, lens + 1, bt, page_ids, offsets,
        k_pages, v_pages, cfg=cfg)                             # (nb, V)

    new_toks = sample_rows_impl(logits, base_key, seeds, lens + 1, temps,
                                top_ks)
    active = lens > 0
    new_lens = torch.where(active, lens + 1, lens)
    toks.copy_(torch.where(active, new_toks, toks))
    lens.copy_(new_lens)
    return new_toks, state, k_pages, v_pages


# ------------------------------------------------------- speculative decode

def _verify_fwd(params, qtoks, qpos, bt, dest_page, dest_slot, total,
                k_pages, v_pages, *, cfg: ModelConfig):
    """Multi-query target forward over the Q = k_spec+1 candidate
    positions: embed + per-layer KV write of ALL candidates at
    (dest_page, dest_slot) + ragged multi-query paged attention
    (`kops.paged_verify`) over `total` tokens per row. Returns
    (logits (B, Q, V), k_pages, v_pages)."""
    h = embed_tokens(params, qtoks, cfg)                       # (B, Q, d)
    for li in range(cfg.n_layers):
        lp = layer(params["layers"], li)
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q = attn._project_q(lp["attn"], x, cfg, qpos, rope=True)
        k_new, v_new = attn._project_kv(lp["attn"], x, cfg, qpos, rope=True)
        k_pages[li, dest_page, dest_slot] = k_new.to(k_pages.dtype)
        v_pages[li, dest_page, dest_slot] = v_new.to(v_pages.dtype)
        o = kops.paged_verify(q.contiguous(), k_pages[li], v_pages[li], bt,
                              total)                           # (B,Q,H,hd)
        h = h + _out_proj(o, lp["attn"]["wo"])
        h = h + _ffn(lp, rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h, cfg), k_pages, v_pages


@torch.no_grad()
def spec_decode_step(params: Any, dparams: Any, state: dict,
                     k_pages: torch.Tensor, v_pages: torch.Tensor,
                     dk_pages: torch.Tensor, dv_pages: torch.Tensor,
                     base_key: torch.Tensor, scratch: int, *,
                     cfg: ModelConfig, dcfg: ModelConfig, page_size: int,
                     nb: int, npgb: int, k_spec: int, synth_rate=None):
    """Fused draft-k/verify-1 speculative decode over `decode_step`'s
    bucketed batch-state contract.

    The drafter shares the target's block tables, page ids and lens (its
    own pools `dk_pages`/`dv_pages` have the target pool's page geometry),
    so the scheduler manages one set of pages. Acceptance is exact-match:
    the target samples T_j at every verified position with the seed+
    position keys sequential decode would use, and draft d_j is accepted
    iff it equals T_j and every earlier draft was accepted; the step emits
    n_acc+1 >= 1 TARGET samples, so the stream equals the non-speculative
    engine's whatever the drafter proposes. Rejected positions' KV is
    rolled back logically: `lens` advances only past accepted tokens, so
    the stale slots lie past every row's ragged edge until the next step
    overwrites them. Writes that would land past the bucket's
    `npgb * page_size` horizon go to the `scratch` page.

    With `synth_rate` (a float in [0, 1]) the accept/reject decision of
    each draft position is a deterministic coin keyed on the same
    seed+position key, tagged by fold_in 7: the benchmark knob of a fixed
    acceptance rate; emitted tokens are then NOT baseline-exact.

    `lens`/`toks` of the state advance in place. Returns (T (nb, k_spec+1)
    int32 target samples, n_acc (nb,) accepted draft counts, state,
    k_pages, v_pages, dk_pages, dv_pages).
    """
    Q = k_spec + 1
    bt = state["bt"][:nb, :npgb].contiguous()
    lens = state["lens"][:nb]
    toks = state["toks"][:nb]
    temps = state["temps"][:nb]
    top_ks = state["top_ks"][:nb]
    seeds = state["seeds"][:nb]
    dev = lens.device
    cap = npgb * page_size

    def dests(positions):
        # (nb, n) positions -> (page ids, slots). A position past the bucket
        # horizon must not clamp onto a REAL page (the wrapped slot would
        # corrupt committed KV): it goes to the scratch page, whose
        # contents are never read back
        col = (positions // page_size).clamp_max(npgb - 1).long()
        pids = torch.where(positions < cap, bt.gather(1, col).long(), scratch)
        return pids, (positions % page_size).long()

    # ---- draft phase: k_spec proposal forwards + 1 write-only forward (the
    # last candidate's KV must be resident for the all-accepted case: the
    # next step's drafter attends position lens + k_spec)
    x = toks
    drafts = []
    for i in range(Q):
        p = lens + i
        pids, offs = dests(p[:, None])
        d_logits, dk_pages, dv_pages = _token_fwd(
            dparams, x, p, p + 1, bt, pids[:, 0], offs[:, 0], dk_pages,
            dv_pages, cfg=dcfg, head=i < k_spec)
        if i < k_spec:
            # drafts draw through the SAME seed+position keys as the
            # target's verify draws: an identical drafter reproduces the
            # target's samples exactly (acceptance 1.0 by construction)
            x = sample_rows_impl(d_logits, base_key, seeds, p + 1, temps,
                                 top_ks)
            drafts.append(x)

    # ---- verify phase: ONE multi-query target forward
    D = (torch.stack(drafts, dim=1) if k_spec
         else toks.new_zeros((nb, 0)))                         # (nb, k)
    qtoks = torch.cat([toks[:, None], D], dim=1)               # (nb, Q)
    qpos = lens[:, None] + torch.arange(Q, dtype=lens.dtype, device=dev)
    dp, dsl = dests(qpos)
    # the verify kernel's lens count ALL Q candidates; inactive padding rows
    # (lens=0, scratch block table) pass the minimum Q
    total = torch.where(lens > 0, lens + Q, Q).to(torch.int32)
    logits, k_pages, v_pages = _verify_fwd(
        params, qtoks, qpos, bt, dp, dsl, total, k_pages, v_pages,
        cfg=cfg)                                               # (nb, Q, V)

    # target samples at every verified position with the sequential keys,
    # all Q columns in one call (each row's draw depends only on its own
    # seed and position)
    T = sample_rows_impl(
        logits.reshape(nb * Q, -1), base_key,
        seeds.repeat_interleave(Q), (qpos + 1).reshape(-1),
        temps.repeat_interleave(Q), top_ks.repeat_interleave(Q)
    ).reshape(nb, Q)

    # exact-match acceptance: the longest leading run of drafts equal to
    # the target's own draws
    if k_spec:
        if synth_rate is None:
            m = (D == T[:, :k_spec]).to(torch.int32)
        else:
            keys = fold_in(fold_key(base_key, seeds[:, None], qpos[:, 1:]),
                           torch.tensor(7, device=dev))        # (nb, k, 2)
            u = uniform(keys.reshape(-1, 2), 1).reshape(nb, k_spec)
            m = (u < torch.tensor(synth_rate, dtype=torch.float32,
                                  device=dev)).to(torch.int32)
        n_acc = torch.cumprod(m, dim=1).sum(dim=1).to(torch.int32)
    else:
        n_acc = torch.zeros((nb,), dtype=torch.int32, device=dev)

    new_toks = T.gather(1, n_acc.long()[:, None])[:, 0]
    active = lens > 0
    toks.copy_(torch.where(active, new_toks, toks))
    lens.copy_(torch.where(active, lens + n_acc + 1, lens))
    return T, n_acc, state, k_pages, v_pages, dk_pages, dv_pages
