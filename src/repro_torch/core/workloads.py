# Copy of src/repro/core/workloads.py (no import of the JAX package).
"""Synthetic workload generators mirroring the paper's evaluation sets.

- multiturn(): WildChat/ChatBot-Arena-style closed-loop conversations —
  per-user sessions whose turn t prompt = shared system template + full
  conversation history + new user message (high within-user prefix
  similarity, template-level cross-user similarity, matching Fig. 5).
- tot(): Tree-of-Thoughts over GSM-style questions — depth-4 trees with
  branching b (b=2 -> 15 requests/tree, b=4 -> 85), children share the
  root..parent prefix and run concurrently (Fig. 8c/8d).
- diurnal_rates(): per-region sinusoidal diurnal demand with timezone
  offsets (Fig. 2/3).

Tokens are ints; a "token" here = one LLM token equivalent.
"""
from __future__ import annotations

import dataclasses
import math
import random
import zlib
from typing import Iterator, Optional

REGIONS = ("us", "eu", "asia")


def stable_hash(*parts) -> int:
    """Process-stable substitute for hash(tuple): builtin str hashing is
    randomized per-process (PYTHONHASHSEED), which made workload streams —
    and therefore every benchmark number — differ across runs. CI diffs
    BENCH_summary.json against a committed baseline, so seeds must derive
    from something reproducible."""
    return zlib.crc32(repr(parts).encode())


@dataclasses.dataclass
class Turn:
    prompt_suffix: tuple      # new user-message tokens for this turn
    output_tokens: tuple      # deterministic completion tokens


@dataclasses.dataclass
class SessionSpec:
    user_id: str
    region: str
    system_prompt: tuple
    turns: list


def _tokens(rng: random.Random, n: int, lo: int = 0, hi: int = 49_999) -> tuple:
    return tuple(rng.randint(lo, hi) for _ in range(n))


def _lognormal_len(rng: random.Random, median: float, sigma: float,
                   lo: int, hi: int) -> int:
    return int(min(hi, max(lo, rng.lognormvariate(math.log(median), sigma))))


def multiturn(n_users_per_region: dict[str, int], *, turns: int = 6,
              n_templates: int = 8, template_len: int = 256,
              user_msg_median: int = 120, output_median: int = 220,
              sigma: float = 0.7, seed: int = 0,
              heterogeneous_frac: float = 0.0,
              sessions_per_user: int = 1) -> list[SessionSpec]:
    """Closed-loop multi-turn conversations. `heterogeneous_frac` of users
    issue unrelated prompts each turn (paper's 'heterogeneous user program'
    pathology — no within-session sharing). `sessions_per_user` > 1 models a
    user opening several conversations: same system template (their custom
    context), fresh histories — within-user-cross-session pairs share only
    the template, which is what keeps measured within-user similarity < 1."""
    rng = random.Random(seed)
    templates = [_tokens(rng, template_len) for _ in range(n_templates)]
    sessions = []
    for region, n_users in n_users_per_region.items():
        for u in range(n_users):
            user_id = f"{region}-u{u}"
            urng = random.Random(stable_hash(seed, region, u))
            tmpl = templates[urng.randrange(n_templates)]
            hetero = urng.random() < heterogeneous_frac
            for sess in range(sessions_per_user):
                tlist = []
                for t in range(turns):
                    plen = _lognormal_len(urng, user_msg_median, sigma, 8, 2048)
                    olen = _lognormal_len(urng, output_median, sigma, 4, 2048)
                    prefix = _tokens(urng, plen) if not hetero else \
                        _tokens(random.Random(stable_hash(
                            seed, region, u, t, sess, "h")), plen)
                    tlist.append(Turn(prompt_suffix=prefix,
                                      output_tokens=_tokens(urng, olen)))
                sessions.append(SessionSpec(user_id, region, tuple(tmpl),
                                            tlist))
    return sessions


@dataclasses.dataclass
class TreeSpec:
    user_id: str
    region: str
    question: tuple           # root prompt (shared prefix of all nodes)
    branching: int
    depth: int
    thought_len: int
    output_len: int
    seed: int
    output_sigma: float = 0.0   # lognormal spread of per-node decode length
                                # (paper Fig. 4a: output length unpredictable)

    def n_requests(self) -> int:
        return sum(self.branching ** d for d in range(self.depth))

    def node_output_len(self, path: tuple) -> int:
        if self.output_sigma <= 0.0:
            return self.output_len
        rng = random.Random(stable_hash(self.seed, path, "olen"))
        return _lognormal_len(rng, self.output_len, self.output_sigma,
                              8, 16 * self.output_len)


def tot(clients_per_region: dict[str, int], *, branching: int = 2,
        depth: int = 4, question_len: int = 384, thought_len: int = 96,
        output_len: int = 160, trees_per_client: int = 3,
        seed: int = 0, branching_overrides: Optional[dict[str, int]] = None,
        output_sigma: float = 0.0) -> list[list[TreeSpec]]:
    """Returns per-client lists of TreeSpec (executed sequentially by the
    client; nodes within a tree run concurrently layer by layer).
    b=2,d=4 -> 1+2+4+8=15 requests; b=4 -> 1+4+16+64=85 (paper §5.1)."""
    rng = random.Random(seed)
    out = []
    for region, n_clients in clients_per_region.items():
        b = (branching_overrides or {}).get(region, branching)
        for c in range(n_clients):
            crng = random.Random(stable_hash(seed, region, c, "tot"))
            trees = []
            for t in range(trees_per_client):
                trees.append(TreeSpec(
                    user_id=f"{region}-c{c}", region=region,
                    question=_tokens(crng, question_len),
                    branching=b, depth=depth, thought_len=thought_len,
                    output_len=output_len,
                    seed=crng.randrange(1 << 30),
                    output_sigma=output_sigma))
            out.append(trees)
    _ = rng
    return out


# ------------------------------------------------------------------ diurnal

TZ_OFFSET_H = {"us": 0.0, "eu": -7.0, "asia": -13.0,
               "sa": 2.0, "oceania": -16.0}       # 5 regions for Fig. 3

#: the five-region set of the paper's diurnal/cost figures (Fig. 2/3)
REGIONS5 = ("us", "eu", "asia", "sa", "oceania")


def diurnal_rate(region: str, hour: float, *, base: float = 0.15,
                 amp: float = 1.0, peak_hour: float = 14.0) -> float:
    """Relative request rate for a region at a given UTC hour (0-24)."""
    try:
        off = TZ_OFFSET_H[region]
    except KeyError:
        # same silent-fallback class as the unknown-RTT bug: an unknown
        # region used to quietly get UTC's curve, which flattens nothing
        # and peaks in the wrong place — fail loudly instead
        raise ValueError(
            f"no timezone offset configured for region {region!r} "
            f"(known: {sorted(TZ_OFFSET_H)})") from None
    local = (hour + off) % 24.0
    x = math.cos((local - peak_hour) / 24.0 * 2 * math.pi)
    return base + amp * max(0.0, x) ** 2


def diurnal_series(regions=REGIONS, hours: int = 24, step_h: float = 1.0,
                   seed: int = 0, noise: float = 0.05,
                   amp_by_region: Optional[dict] = None
                   ) -> dict[str, list[float]]:
    # integer sample count: the old `while t < hours: t += step_h` loop
    # accumulated float error for non-integer steps (step_h=0.1 emitted 241
    # samples instead of 240), so per-region series could go ragged
    n = max(1, round(hours / step_h))
    rng = random.Random(seed)
    out = {}
    for r in regions:
        amp = (amp_by_region or {}).get(r, 1.0)
        out[r] = [diurnal_rate(r, i * step_h, amp=amp)
                  * (1 + rng.uniform(-noise, noise)) for i in range(n)]
    return out


# ------------------------------------------------------------------ tenants

def zipf_shares(n_tenants: int, alpha: float = 1.2) -> list[float]:
    """Normalized Zipf demand shares: tenant k (rank order) draws traffic
    with probability proportional to 1/(k+1)^alpha. alpha around 1.2 gives
    the 'few abusive tenants, many light ones' shape of production
    multi-tenant serving."""
    w = [(k + 1) ** -alpha for k in range(n_tenants)]
    tot = sum(w)
    return [x / tot for x in w]


def tenant_request_stream(region: str, *, n_tenants: int = 20,
                          alpha: float = 1.2, heavy_tenants: int = 2,
                          heavy_prefix_len: int = 384, prompt_len: int = 48,
                          light_prefix_len: int = 32, output_len: int = 48,
                          seed: int = 0) -> Iterator[tuple[str, tuple, int]]:
    """Heavy-tailed per-tenant demand: an infinite stream of
    (user_id, prompt_tokens, output_len) where the tenant of each arrival
    is drawn Zipf(alpha) over `user_id` (seeded via `stable_hash`, so the
    stream is process-stable like every other generator here).

    The heaviest `heavy_tenants` ranks carry a LONG shared per-tenant
    prefix — their traffic is maximally cache-affine, which is exactly the
    abuse pattern the fairness work must defuse: under FCFS their prefix
    hits buy them both replica batch slots and the router's affinity
    preference, starving the light tenants. Light tenants share only a
    short prefix (ordinary session reuse)."""
    rng = random.Random(stable_hash(seed, region, "tenants"))
    shares = zipf_shares(n_tenants, alpha)
    cum, acc = [], 0.0
    for s in shares:
        acc += s
        cum.append(acc)
    prefixes = []
    for k in range(n_tenants):
        plen = heavy_prefix_len if k < heavy_tenants else light_prefix_len
        prefixes.append(_tokens(
            random.Random(stable_hash(seed, region, "tpfx", k)), plen))
    while True:
        x = rng.random()
        k = next((i for i, c in enumerate(cum) if x <= c), n_tenants - 1)
        prompt = prefixes[k] + _tokens(rng, prompt_len)
        yield f"{region}-t{k}", prompt, output_len


def prefix_similarity(a, b) -> float:
    """len(common_prefix)/min(len) — the paper's metric (footnote 1)."""
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i / n
