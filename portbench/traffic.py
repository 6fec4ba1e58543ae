"""The one traffic generator: it reads a mix's parameters (a JSON file
under ``traffic/``) and the run's seed, and returns the requests' sizes
and arrivals.

A mix file holds:

* ``loop``: ``"open"`` (independent users: requests fall due on a
  schedule whatever the system does) or ``"closed"`` (``clients``
  callers, each sending its next request as its last one completes);
* ``rate`` (open loop): requests a second.  Gaps are exponential
  (Poisson arrivals); with ``burst`` = ``{"period_s": p, "on_share":
  f}`` requests fall due only in the first ``f`` of every period, at
  ``rate / f``, so the mean rate stays ``rate``;
* ``tasks``: ``[{"task": name, "share": w, "prompt": L, "output": L}]``
  where a length ``L`` is a whole number, ``{"min": a, "max": b}``
  (uniform) or ``{"min": a, "max": b, "median": m, "sigma": s}``
  (log-normal, clipped); ``prompt`` is the text tokens, ``output`` the
  tokens to generate (0 or absent: the task returns one answer);
* ``scheduler``: the ``SchedulerConfig`` the cell serves with;
* ``pool`` (inputs drawn at set-up and reused in turn), ``sample``
  (answers the check keeps, a seeded reservoir of each task's over the
  answers that come once the window is open), ``sample_tokens`` (generative: served requests whose every
  token the check compares, the longest among them; all by default),
  ``trace_slice_s`` (seconds the
  profiler records in a ``--trace 1`` run), ``lead_in`` (closed loop:
  completions after every client has sent its first request and before
  the window opens; the clients' number by default).

Every seed gets the same sizes and the same gaps, in another order: the
sequence of requests is made of blocks (``block`` requests, 64 by
default) that each hold the tasks in their shares and each task's
lengths at the quantiles of their distribution; the gaps are the
quantiles of the exponential; the seed shuffles each block and the
gaps.  So runs
of different seeds offer the same work; the seed changes the order and
the contents (which ``configs/<name>.py`` draws from it).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from statistics import NormalDist

import numpy as np

from portbench.weights import sub_seed

#: closed loop: the length of the sequence of requests the clients take
#: from, in turn (it wraps, with fresh request ids, if a run takes more)
CYCLE = 8192
#: requests in a block of the sequence, unless the mix says
BLOCK = 64


@dataclass(frozen=True, slots=True)
class Spec:
    rid: int
    task: str
    prompt: int           # text tokens (0: none)
    output: int           # tokens to generate (0: one answer)
    due: float = 0.0      # open loop: seconds after the window opens


@dataclass
class Plan:
    mix: dict
    loop: str
    specs: list           # open: in order of due time; closed: the cycle
    clients: int = 0
    base: list = field(default_factory=list)   # closed: the cycle uncut

    def closed_spec(self, k: int) -> Spec:
        """The k-th request of a closed loop (k >= clients)."""
        if k < len(self.specs):
            return self.specs[k]
        t, p, o = self.base[k % len(self.base)]
        return Spec(k, t, p, o)


def load_mix(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def quantiles(dist, n: int) -> list[int]:
    """n lengths of ``dist`` at the quantiles (i + 0.5) / n."""
    if dist is None:
        return [0] * n
    if isinstance(dist, (int, float)):
        return [int(dist)] * n
    lo, hi = int(dist["min"]), int(dist["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if "median" in dist:
            z = NormalDist().inv_cdf(u)
            x = math.exp(math.log(dist["median"]) + dist.get("sigma", 1.0) * z)
            v = int(round(x))
        else:
            v = lo + int(u * (hi - lo + 1))
        out.append(min(max(v, lo), hi))
    return out


def _task_counts(tasks, n: int) -> list[int]:
    """Counts proportional to the shares, by largest remainder."""
    w = np.array([float(t["share"]) for t in tasks])
    exact = n * w / w.sum()
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts), kind="stable")[:n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def _sizes(tasks, n: int, rng, block: int) -> list[tuple[str, int, int]]:
    """n (task, prompt, output) triples in blocks of ``block``: every
    block holds the tasks in their shares and each task's lengths at
    its distribution's quantiles, paired alike for every seed; ``rng``
    shuffles each block.  So any stretch of the sequence offers nearly
    the same work whatever the seed."""
    one = []
    pairing = np.random.default_rng(0)     # the same pairs for every seed
    for t, c in zip(tasks, _task_counts(tasks, block)):
        prompts = quantiles(t.get("prompt"), c)
        outputs = quantiles(t.get("output"), c)
        pairing.shuffle(outputs)
        one += [(t["task"], p, o) for p, o in zip(prompts, outputs)]
    out = []
    while len(out) < n:
        out += [one[i] for i in rng.permutation(len(one))]
    return out[:n]


def arrivals(mix: dict, seconds: float, rng) -> list[float]:
    """Open loop: the due times in [0, seconds), Poisson (or on/off)."""
    rate = float(mix["rate"])
    n = max(1, int(round(rate * seconds)))
    burst = mix.get("burst")
    on = float(burst["on_share"]) if burst else 1.0
    span = seconds * on                # time in the on phases
    gaps = np.array([-math.log1p(-(i + 0.5) / n) for i in range(n)])
    gaps *= span / gaps.sum()
    rng.shuffle(gaps)
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    if burst:
        period = float(burst["period_s"])
        on_len = period * on
        t = np.floor(t / on_len) * period + np.mod(t, on_len)
    return [float(x) for x in t if x < seconds]


def make_plan(mix: dict, seed: int, seconds: float) -> Plan:
    rng = np.random.default_rng(sub_seed(seed, "traffic"))
    tasks = mix["tasks"]
    block = int(mix.get("block", BLOCK))
    if mix["loop"] == "open":
        due = arrivals(mix, seconds, rng)
        sizes = _sizes(tasks, len(due), rng, block)
        specs = [Spec(i, t, p, o, d)
                 for i, ((t, p, o), d) in enumerate(zip(sizes, due))]
        return Plan(mix, "open", specs)
    if mix["loop"] != "closed":
        raise ValueError(f"loop {mix['loop']!r} is not 'open' or 'closed'")
    clients = int(mix["clients"])
    sizes = _sizes(tasks, CYCLE, rng, block)
    # each client's first request is cut short by a quantile of its
    # length, as the remainder of a request already under way: the rows
    # start at spread ages, not all at once
    cut = rng.permutation(clients)
    specs = []
    for i, (t, p, o) in enumerate(sizes):
        if i < clients and o > 1:
            o = max(1, int(math.ceil(o * (cut[i] + 0.5) / clients)))
        specs.append(Spec(i, t, p, o))
    return Plan(mix, "closed", specs, clients=clients, base=sizes)
