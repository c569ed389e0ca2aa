"""PyTorch paged-KV backend for ReplicaCore (port of
`repro.serving.jax_backend.JaxPagedBackend`'s prefill and decode paths):
real prefill / decode / sampling over the shared page pool via
`model_runner`, while every scheduling decision (admission, eviction,
preemption, chunking) stays in `repro_torch.replica.core.ReplicaCore`.

  decode   The batch lives in a PERSISTENT DEVICE-RESIDENT state (block
           tables, seq lens, last sampled tokens, per-row sampling params)
           at full capacity shape; `mr.decode_step` slices the active
           power-of-two bucket `(nb, npgb)`, so steady-state steps upload
           NOTHING and run one of a bounded set of shapes. The step
           advances lens/tokens on device; the host downloads the sampled
           tokens once per step (the step's one host sync) for scheduler
           bookkeeping. Host mirrors are updated incrementally and the
           device state is re-uploaded only when batch MEMBERSHIP changes
           (admission / completion / preemption), detected by sequence and
           block-table identity.

  prefill  Admissions are packed: `prefill_batch` ragged-packs every
           admitted suffix into ONE `mr.prefill_pack_step` call, with each
           segment attending to its own radix-cached prefix and its
           boundary token sampled on device. `mr.prefill_step` serves
           `packed_prefill=False`.

Sampling is per sequence and keyed on (engine seed, request seed, token
position), so bucketing can never change a sampled token.

Not in this backend yet (later slices of the port): the host KV tier
(`on_demote` / `load_pages` / `finish_load`), cross-region page export and
import, and speculative `decode_many`.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import leaves
from repro_torch.serving import model_runner as mr
from repro_torch.serving.bucketing import bucket, pow2_pad, token_pad
from repro_torch.serving.sampling import prng_key, sample_rows_impl


class TorchPagedBackend:
    """ReplicaBackend over a real paged KV pool on `device`. Must be
    `bind()`-ed to its ReplicaCore after construction: the core's reserved
    pages provide the scratch page ids used to pad block tables (never read
    back thanks to seq_len masking, but they must stay allocated), and the
    core's config sizes the persistent device batch state."""

    def __init__(self, model_cfg: ModelConfig, params: Any, *,
                 n_pages: int, page_size: int, device, prefill_pad: int = 64,
                 seed: int = 0, bucket_shapes: bool = True,
                 packed_prefill: bool = True):
        self.cfg = model_cfg
        self.params = params
        self.device = torch.device(device)
        self.page_size = page_size
        self.prefill_pad = prefill_pad
        self.bucket_shapes = bucket_shapes
        self.packed_prefill = packed_prefill
        kv_dtype = next(leaves(params)).dtype       # the KV pool's dtype
        self.k_pages, self.v_pages = mr.init_kv_pool(
            model_cfg, n_pages, page_size, kv_dtype, self.device)
        self._base_key = prng_key(seed, self.device)
        self._scratch: Optional[int] = None
        # distinct (nb, npgb) decode buckets run so far: bounded by the
        # bucket ladders, the analog of the JAX step's compile count
        self.decode_buckets: set = set()

    def bind(self, core) -> None:
        if not core.reserved:
            raise ValueError("TorchPagedBackend needs ReplicaCoreConfig."
                             "reserved_pages >= 1 for block-table padding")
        self._scratch = core.reserved[0]
        ccfg = core.cfg
        pool = ccfg.n_pages - ccfg.reserved_pages
        self._bcap = ccfg.max_batch or max(1, pool)
        max_len = ccfg.max_seq_len or pool * self.page_size
        self._npg_cap = max(1, -(-max_len // self.page_size))
        # host mirrors of the device batch state (updated incrementally;
        # uploaded only when membership changes)
        self._m_bt = np.full((self._bcap, self._npg_cap), self._scratch,
                             np.int32)
        self._m_lens = np.zeros(self._bcap, np.int32)
        self._m_toks = np.zeros(self._bcap, np.int32)
        self._m_temps = np.zeros(self._bcap, np.float32)
        self._m_topks = np.zeros(self._bcap, np.int32)
        self._m_seeds = np.zeros(self._bcap, np.int32)
        # (seq, its pages-list identity) per device row; a preempted+resumed
        # sequence gets a fresh pages list, so identity detects stale rows
        # even when it lands back on the same row
        self._slots: list = []
        self._dstate: Optional[dict] = None
        self._nb = 0
        self._npgb = 0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        # a copy on every device: on the CPU a view would alias the host
        # mirrors that the step then advances in place
        return torch.tensor(a, device=self.device)

    # ------------------------------------------------------------ prefill
    def _sample_pref(self, logits, seq, pos: int) -> int:
        """Sample one prefill boundary token (same per-row RNG as the
        packed/decode paths, so every path draws identical tokens)."""
        sp = seq.req.sampling
        tok = sample_rows_impl(
            logits, self._base_key,
            self._dev(np.asarray([sp.seed], np.int32)),
            self._dev(np.asarray([pos], np.int32)),
            self._dev(np.asarray([sp.temperature], np.float32)),
            self._dev(np.asarray([sp.top_k], np.int32)))
        return int(tok[0])

    def prefill(self, seq, start: int, end: int, sample: bool) -> Optional[int]:
        """One-request path (`packed_prefill=False`); the packed path below
        is the default."""
        ps = self.page_size
        suffix = seq.tokens[start:end]
        S = self._token_pad(len(suffix))
        toks = np.zeros((1, S), np.int64)
        toks[0, :len(suffix)] = suffix
        # page list covering all S (padded) rows: this chunk's pages first,
        # then the scratch page repeated (padding rows write garbage there;
        # rows past len(suffix) inside real pages are masked until decode
        # overwrites them)
        np_total = -(-S // ps)
        chunk_pages = seq.pages[start // ps: -(-end // ps)]
        np_new = np.asarray(
            (chunk_pages + [self._scratch] * np_total)[:max(np_total, 1)],
            np.int64)
        past = seq.pages[:start // ps]
        np_past = np.asarray(past if past else [self._scratch], np.int64)
        logits, self.k_pages, self.v_pages = mr.prefill_step(
            self.params, self._dev(toks), self._dev(np_new),
            self.k_pages, self.v_pages, self._dev(np_past),
            start, len(suffix), cfg=self.cfg, page_size=ps)
        if not sample:
            return None
        tok = self._sample_pref(logits, seq, end)
        if seq.req.first_token_s is None:
            seq.req.first_token_s = time.monotonic()
        return tok

    def prefill_batch(self, items) -> list:
        """Packed batched prefill: one call for a whole admission round.
        items: [(seq, start, end, sample)] with page-aligned starts."""
        if not self.packed_prefill:
            return [self.prefill(seq, s, e, smp) for seq, s, e, smp in items]
        ps = self.page_size
        nseg = len(items)
        seg_lens = [end - start for _, start, end, _ in items]
        S = self._token_pad(sum(seg_lens))
        toks = np.zeros(S, np.int64)
        segs = np.full(S, -1, np.int64)
        poss = np.zeros(S, np.int64)
        dpage = np.full(S, self._scratch, np.int64)
        dslot = np.zeros(S, np.int64)
        past_lists = []
        off = 0
        for j, (seq, start, end, _) in enumerate(items):
            n = end - start
            idx = np.arange(start, end)
            toks[off:off + n] = seq.tokens[start:end]
            segs[off:off + n] = j
            poss[off:off + n] = idx
            dpage[off:off + n] = np.asarray(seq.pages, np.int64)[idx // ps]
            dslot[off:off + n] = idx % ps
            past_lists.append(seq.pages[:start // ps])
            off += n
        cp_off = np.cumsum([0] + [len(p) for p in past_lists])
        CP = self._pow2_pad(max(int(cp_off[-1]), 1))
        past = np.full(CP, self._scratch, np.int64)
        for j, pages in enumerate(past_lists):
            past[cp_off[j]:cp_off[j + 1]] = pages
        NS = self._pow2_pad(nseg)
        past_start = np.zeros(NS, np.int64)
        past_len = np.zeros(NS, np.int64)
        last_idx = np.zeros(NS, np.int64)
        temps = np.zeros(NS, np.float32)
        topks = np.zeros(NS, np.int32)
        seeds = np.zeros(NS, np.int32)
        spos = np.zeros(NS, np.int32)
        seg_off = np.cumsum([0] + seg_lens)
        for j, (seq, start, end, _) in enumerate(items):
            sp = seq.req.sampling
            past_start[j] = cp_off[j] * ps
            past_len[j] = start
            last_idx[j] = seg_off[j + 1] - 1
            temps[j] = sp.temperature
            topks[j] = sp.top_k
            seeds[j] = sp.seed
            spos[j] = end
        toks_dev, self.k_pages, self.v_pages = mr.prefill_pack_step(
            self.params, self._dev(toks), self._dev(segs), self._dev(poss),
            self._dev(dpage), self._dev(dslot), self.k_pages, self.v_pages,
            self._dev(past), self._dev(past_start), self._dev(past_len),
            self._dev(last_idx), self._dev(temps), self._dev(topks),
            self._dev(seeds), self._dev(spos), self._base_key,
            cfg=self.cfg, page_size=ps)
        tn = toks_dev.cpu().numpy()                # one host sync per round
        now = time.monotonic()
        out: list = []
        for j, (seq, _start, _end, smp) in enumerate(items):
            if not smp:
                out.append(None)
                continue
            if seq.req.first_token_s is None:
                seq.req.first_token_s = now
            out.append(int(tn[j]))
        return out

    # ------------------------------------------------------------ decode
    def decode(self, seqs) -> list[int]:
        n = len(seqs)
        if not self._slots_current(seqs):
            self._sync_slots(seqs)
        self.decode_buckets.add((self._nb, self._npgb))
        toks, self._dstate, self.k_pages, self.v_pages = mr.decode_step(
            self.params, self._dstate, self.k_pages, self.v_pages,
            self._base_key, cfg=self.cfg, page_size=self.page_size,
            nb=self._nb, npgb=self._npgb)
        out = toks.cpu().numpy()               # the single host sync
        # advance the mirrors exactly like the step advanced the device
        # state (active rows only)
        active = self._m_lens[:self._nb] > 0
        self._m_lens[:self._nb] += active
        self._m_toks[:self._nb] = np.where(active, out[:self._nb],
                                           self._m_toks[:self._nb])
        return [int(t) for t in out[:n]]

    def _slots_current(self, seqs) -> bool:
        if len(self._slots) != len(seqs):
            return False
        return all(sl_seq is s and sl_pages is s.pages
                   for (sl_seq, sl_pages), s in zip(self._slots, seqs))

    def _sync_slots(self, seqs) -> None:
        """Batch membership changed: rewrite the rows that differ, zero the
        rows that emptied, pick the shape bucket, upload the state."""
        n = len(seqs)
        old = self._slots
        for i, s in enumerate(seqs):
            if i < len(old) and old[i][0] is s and old[i][1] is s.pages:
                continue
            self._m_bt[i, :] = self._scratch
            self._m_bt[i, :len(s.pages)] = s.pages
            self._m_lens[i] = s.pos - 1        # last token not yet in cache
            self._m_toks[i] = s.tokens[-1]
            sp = s.req.sampling
            self._m_temps[i] = sp.temperature
            self._m_topks[i] = sp.top_k
            self._m_seeds[i] = sp.seed
        for i in range(n, len(old)):           # rows that shrank away
            self._m_bt[i, :] = self._scratch
            self._m_lens[i] = 0
            self._m_toks[i] = 0
            self._m_temps[i] = 0.0
            self._m_topks[i] = 0
            self._m_seeds[i] = 0
        self._slots = [(s, s.pages) for s in seqs]
        npg_need = max(len(s.pages) for s in seqs)
        if self.bucket_shapes:
            self._nb = bucket(n, self._bcap)
            self._npgb = bucket(npg_need, self._npg_cap)
        else:
            self._nb, self._npgb = n, npg_need
        self._dstate = {
            "bt": self._dev(self._m_bt),
            "lens": self._dev(self._m_lens),
            "toks": self._dev(self._m_toks),
            "temps": self._dev(self._m_temps),
            "top_ks": self._dev(self._m_topks),
            "seeds": self._dev(self._m_seeds),
        }

    # ------------------------------------------------------------ shapes
    # (one implementation for every caller: repro_torch.serving.bucketing)
    def _token_pad(self, n: int) -> int:
        return token_pad(n, self.prefill_pad, self.bucket_shapes)

    def _pow2_pad(self, n: int) -> int:
        return pow2_pad(n, self.bucket_shapes)
