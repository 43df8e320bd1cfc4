"""The benchmark's traffic: the frozen corpus draws what the port's
generator draws, and every seed of a cell gets the same work."""

import json
import random
from collections import Counter

import pytest

from driftbench.bench import BENCH
from driftbench.gen import traffic


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mix", ["chat.paced", "rag.paced"])
def test_content_equals_the_port_generator(seed, mix):
    from repro_torch.core.request import Category, TenantTier
    from repro_torch.workload.generator import (GeneratorConfig,
                                                WorkloadGenerator)
    content = _mix(mix)["content"]
    cfg = GeneratorConfig(
        category_weights={Category(k): v for k, v
                          in content["category_weights"].items()},
        tenant_weights={TenantTier[k.upper()]: v for k, v
                        in content["tenant_weights"].items()},
        max_tokens=content["max_tokens"],
        output_noise_sigma=content["output_noise_sigma"],
        prompt_tokens_scale=content["prompt_tokens_scale"])
    gen, rng = WorkloadGenerator(cfg), random.Random(seed)
    theirs = [gen.make_request(rng) for _ in range(300)]
    ours = traffic.draw_content(content, 300, seed)
    for a, b in zip(theirs, ours):
        assert (a.category.value, a.tenant.label, a.prompt, a.prompt_tokens,
                a.max_tokens, a.true_output_tokens) == (
            b["category"], b["tenant"], b["prompt"], b["prompt_tokens"],
            b["max_tokens"], b["true_output_tokens"])


def _work(records):
    return Counter((r.prompt, r.true_output_tokens) for r in records)


@pytest.mark.parametrize("mix", ["chat.paced", "chat.bursty"])
def test_every_seed_gets_the_same_work_in_another_order(mix):
    t = _mix(mix)
    a = traffic.plan(t, 6.0, 40.0, 1)
    b = traffic.plan(t, 6.0, 40.0, 2**31 + 11)
    assert _work(a) == _work(b)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    gaps = lambda rs: sorted(round(y.due - x.due, 9)             # noqa: E731
                             for x, y in zip(rs, rs[1:]))
    if mix == "chat.paced":
        assert gaps(a)[:50] == gaps(b)[:50]
    assert all(0 <= r.due < 40.0 for r in a)
    assert a == sorted(a, key=lambda r: r.due)
    assert traffic.plan(t, 6.0, 40.0, 1) == a


def test_bursts_are_on_then_off():
    t = _mix("chat.bursty")
    recs = traffic.plan(t, 4.0, 60.0, 3)
    assert all((r.due // 2.5) % 2 == 0 for r in recs)
    assert 0.6 * 4.0 * 60 < len(recs) < 1.4 * 4.0 * 60


def test_chat_lengths_match_the_paper_mix():
    recs = traffic.draw_content(_mix("chat.paced")["content"], 3000, 0)
    outs = sorted(r["true_output_tokens"] for r in recs)
    prompts = [r["prompt_tokens"] for r in recs]
    assert 3 <= min(prompts) and max(prompts) <= 33
    assert 220 < sum(outs) / len(outs) < 240
    assert outs[-1] < 1024
