"""Top-k MoE with grouped sort-based capacity dispatch (PyTorch port of
`repro.models.moe`: GShard-style token dropping, groups = batch rows).

Per group: top-k route -> a stable sort of the assignments by expert ->
the rank within each expert's run -> assignments ranked past the group's
capacity C are dropped -> gather (E, C, d) -> SiLU-gated expert MLP ->
weighted combine back to the group's tokens. The JAX package's
`_pin_groups` sharding hints have no counterpart here.

The combine is where the two frameworks part. The JAX package scatter-adds
the E*C slots into their tokens; `index_add_` on CUDA adds with atomics in
no fixed order, so in bf16 a token's sum, and then a greedy stream, would
change from run to run. Here each token sums its kept slots in slot order
(expert-major, the order of the JAX package's slot list) in the output
dtype, from zeros, so a run repeats itself bit for bit on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import normal_init


def init_moe(cfg: ModelConfig, dtype, device, generator, lead=()) -> dict:
    """Router (d, E) in fp32 whatever `dtype`, as the JAX package keeps it;
    expert weights w_gate / w_up (E, d, f) and w_down (E, f, d) in `dtype`.
    Scales as `moe.py:36-37`; `lead` stacks them (the layer axis)."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.n_experts
    s_in = d ** -0.5
    s_out = f ** -0.5 / (2 * max(cfg.n_layers, 1)) ** 0.5
    return {
        "router": normal_init((*lead, d, E), s_in, torch.float32, device,
                              generator),
        "w_gate": normal_init((*lead, E, d, f), s_in, dtype, device,
                              generator),
        "w_up": normal_init((*lead, E, d, f), s_in, dtype, device, generator),
        "w_down": normal_init((*lead, E, f, d), s_out, dtype, device,
                              generator),
    }


def capacity(group_tokens: int, cfg: ModelConfig) -> int:
    """Per-group expert capacity (a group = one batch row), padded to a
    multiple of 8."""
    m = cfg.moe
    c = int(m.top_k * group_tokens * m.capacity_factor / m.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def _topk_iterative(probs: torch.Tensor, k: int):
    """top-k over the last axis as k masked argmaxes. Ties go to the lowest
    index, as `torch.argmax` documents and `jnp.argmax` does; `torch.topk`
    leaves the order among equal values unspecified."""
    vals, idxs = [], []
    cur = probs
    for _ in range(k):
        i = cur.argmax(dim=-1, keepdim=True)
        vals.append(cur.gather(-1, i))
        idxs.append(i)
        cur = cur.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _dispatch_group(gate_vals: torch.Tensor, eids: torch.Tensor, E: int,
                    C: int):
    """Assignments -> slots, for one group or a batch of them along leading
    axes. gate_vals / eids: (..., T, k).

    The flat assignments, token-major then k, are sorted by expert id
    stably; an assignment's rank within its expert's run gives its slot
    e * C + rank, and ranks >= C go to the trash slot E * C, which is
    sliced off. Only the trash slot is written more than once.

    Returns (slot_tok (..., E*C) int64, slot_gate (..., E*C) fp32,
    a_slot (..., T*k) int64): each slot's token and gate (token 0 and gate
    0 where no assignment landed), and each assignment's slot in
    token-major, k order (E * C when dropped)."""
    *lead, T, k = eids.shape
    A = T * k
    s_eid, order = torch.sort(eids.reshape(*lead, A), dim=-1, stable=True)
    ar = torch.arange(A, device=eids.device)
    is_start = torch.ones_like(s_eid, dtype=torch.bool)
    is_start[..., 1:] = s_eid[..., 1:] != s_eid[..., :-1]
    run_start = torch.where(is_start, ar, 0).cummax(dim=-1).values
    rank = ar - run_start
    keep = rank < C
    slot = torch.where(keep, s_eid * C + rank, E * C)
    s_gate = gate_vals.reshape(*lead, A).float().gather(-1, order)
    slot_tok = torch.zeros((*lead, E * C + 1), dtype=torch.int64,
                           device=eids.device).scatter_(-1, slot, order // k)
    slot_gate = torch.zeros((*lead, E * C + 1), dtype=torch.float32,
                            device=eids.device).scatter_(
        -1, slot, torch.where(keep, s_gate, 0.0))
    a_slot = torch.empty_like(slot).scatter_(-1, order, slot)
    return slot_tok[..., :-1], slot_gate[..., :-1], a_slot


def _experts(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """The SiLU-gated expert MLPs over the dispatched rows xe (G, E, C, d),
    w_down's product in h's dtype (`moe.py:126-131`)."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    return torch.einsum("gecf,efd->gecd", h, p["w_down"]).to(h.dtype)


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (G, T, d) -> (y (G, T, d), aux_loss). Groups are batch rows."""
    m = cfg.moe
    G, T, d = x.shape
    E, k = m.n_experts, m.top_k
    C = capacity(T, cfg)

    logits = x.float() @ p["router"]                             # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eids = _topk_iterative(probs, k)                  # (G, T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing aux loss (Switch-style), reduced per group first
    me_g = probs.mean(dim=1)                                     # (G, E)
    ce_g = torch.zeros((G, E), dtype=torch.float32, device=x.device) \
        .scatter_add_(1, eids.reshape(G, T * k),
                      torch.ones((G, T * k), device=x.device)) / (T * k)
    aux = m.router_aux_coef * E * torch.sum(me_g.mean(0) * ce_g.mean(0))

    slot_tok, slot_gate, a_slot = _dispatch_group(gate_vals, eids, E, C)
    xe = x.gather(1, slot_tok[..., None].expand(G, E * C, d)) \
        .reshape(G, E, C, d)
    ye = _experts(p, xe)                                         # (G,E,C,d)

    yw = ye.reshape(G, E * C, d) * slot_gate[..., None].to(ye.dtype)
    # each token sums its kept slots in slot order; a token with fewer
    # than k kept slots reads zero rows (the trash index E * C), and
    # adding +0 to a sum that started at +0 changes no bit
    tok_slots = a_slot.reshape(G, T, k).sort(dim=-1).values
    rows = torch.cat([yw, yw.new_zeros((G, 1, d))], dim=1).gather(
        1, tok_slots.reshape(G, T * k, 1).expand(G, T * k, d)) \
        .reshape(G, T, k, d)
    out = torch.zeros((G, T, d), dtype=yw.dtype, device=x.device)
    for r in range(k):
        out = out + rows[:, :, r]
    # the slots no assignment filled carry (token 0, gate 0), as in the
    # JAX package: their 0 * y terms go to token 0 (+-0, or NaN where y is
    # not finite, whatever the order)
    filled = torch.zeros((G, E * C + 1), dtype=torch.bool, device=x.device) \
        .scatter_(1, a_slot, True)[:, :-1]
    empty = torch.where(filled[..., None], 0.0, yw).sum(dim=1)
    out[:, 0] = out[:, 0] + empty
    return out, aux
