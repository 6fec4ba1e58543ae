"""The traffic generator: deterministic per seed, true to its mix."""

import math
from collections import Counter

import pytest

from portbench import traffic

MIX_OPEN = {"loop": "open", "rate": 200.0,
            "tasks": [{"task": "a", "share": 1}, {"task": "b", "share": 2,
                                                  "prompt": 77}]}
MIX_CLOSED = {"loop": "closed", "clients": 16, "tasks": [
    {"task": "gen", "share": 0.4,
     "prompt": {"min": 8, "max": 256, "median": 32, "sigma": 1.0},
     "output": {"min": 16, "max": 96, "median": 40, "sigma": 0.5}},
    {"task": "short", "share": 0.4, "prompt": {"min": 16, "max": 256},
     "output": {"min": 1, "max": 8}},
    {"task": "cls", "share": 0.2}]}


@pytest.mark.parametrize("mix", [MIX_OPEN, MIX_CLOSED],
                         ids=["open", "closed"])
def test_same_seed_same_plan(mix):
    a = traffic.make_plan(mix, 2**33 + 5, 10.0)
    b = traffic.make_plan(mix, 2**33 + 5, 10.0)
    c = traffic.make_plan(mix, 17, 10.0)
    assert a.specs == b.specs
    assert a.specs != c.specs


def test_open_loop_rate_and_window():
    plan = traffic.make_plan(MIX_OPEN, 3, 10.0)
    due = [s.due for s in plan.specs]
    assert len(due) == 2000
    assert due == sorted(due) and 0.0 <= due[0] and due[-1] < 10.0
    counts = Counter(s.task for s in plan.specs[:1984])    # 31 blocks
    assert counts == {"a": 31 * 21, "b": 31 * 43}
    assert all(s.prompt == 77 for s in plan.specs if s.task == "b")
    # Poisson: the gaps' spread is the exponential's (CV near 1)
    gaps = [b - a for a, b in zip(due, due[1:])]
    mu = sum(gaps) / len(gaps)
    sd = math.sqrt(sum((g - mu) ** 2 for g in gaps) / len(gaps))
    assert 0.9 < sd / mu < 1.1


def test_every_seed_offers_the_same_work():
    a = traffic.make_plan(MIX_CLOSED, 1, 10.0).base
    b = traffic.make_plan(MIX_CLOSED, 2, 10.0).base
    assert sorted(a) == sorted(b) and a != b
    oa = traffic.make_plan(MIX_OPEN, 1, 10.0)
    ob = traffic.make_plan(MIX_OPEN, 2, 10.0)
    gaps = lambda p: sorted(round(y.due - x.due, 9)  # noqa: E731
                            for x, y in zip(p.specs, p.specs[1:]))
    assert len(oa.specs) == len(ob.specs)
    assert abs(sum(gaps(oa)) - sum(gaps(ob))) < 0.5


def test_any_whole_blocks_offer_the_same_work():
    mix = dict(MIX_CLOSED, block=40)
    a = traffic.make_plan(mix, 5, 10.0).base
    b = traffic.make_plan(mix, 6, 10.0).base
    for k in (1, 3, 7):
        assert sorted(a[:40 * k]) == sorted(b[:40 * k])
    assert a[:40] != b[:40]


def test_closed_loop_lengths_follow_the_mix():
    plan = traffic.make_plan(MIX_CLOSED, 9, 10.0)
    specs = plan.specs[plan.clients:]
    shares = Counter(s.task for s in specs)
    assert abs(shares["gen"] / len(specs) - 0.4) < 0.01
    assert abs(shares["cls"] / len(specs) - 0.2) < 0.01
    gen = sorted(s.prompt for s in specs if s.task == "gen")
    assert gen[0] >= 8 and gen[-1] <= 256
    assert 28 <= gen[len(gen) // 2] <= 36        # the median, 32
    outs = [s.output for s in specs if s.task == "short"]
    assert min(outs) == 1 and max(outs) == 8
    assert all(s.output == 0 and s.prompt == 0
               for s in specs if s.task == "cls")
    # the clients' first requests are cut: they start at spread ages
    first = [s.output for s in plan.specs[:plan.clients] if s.task == "gen"]
    assert all(o >= 1 for o in first)
    assert plan.closed_spec(20000).rid == 20000


def test_bursts_keep_the_mean_rate():
    mix = dict(MIX_OPEN, burst={"period_s": 2.0, "on_share": 0.25})
    plan = traffic.make_plan(mix, 4, 10.0)
    assert len(plan.specs) == 2000
    assert all((s.due % 2.0) < 0.5 + 1e-9 for s in plan.specs)
