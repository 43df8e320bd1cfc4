"""The harness reads any engine path a cell's files can choose: on the
CPU at a smoke size, the paged pool (with and without a prefix cache)
yields every token to the same wrappers as the slot ring, a traced run
times its model calls with their FLOPs, the prefix layout of the
prompts is the engine's own, and the engine's counters reach the run."""

import random

import pytest

from driftbench import bench, check, harness
from driftbench.gen import traffic
from driftbench.reference import tokens
from driftbench.tests.test_driftbench_faults import (FAMILIES, StepClock,
                                                     smoke_cell)

SHARED = 32          # two whole pages: what the prefix cache shares


def paged_cell(prefix_cache):
    cell = smoke_cell(*FAMILIES["dense"])
    cell.spec["engine"].update(paged=True, page_size=16, max_len=96,
                               chunk_prefill_tokens=24,
                               prefix_cache=prefix_cache)
    if prefix_cache:
        cell.traffic["content"]["shared_prefix_tokens"] = SHARED
        cell.traffic["content"]["prefix_groups_per_tenant"] = 2
    return cell


def traced_window(cell, seed=5):
    params = harness.draw_weights(cell, seed, "cpu")
    clock = StepClock()
    run = harness.run_window(cell, seed, 2.0, True, "cpu", params, 0.0,
                             clock=clock, sleep=clock.sleep)
    run.engine = run.prof = None
    return run


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_the_paged_pool_yields_every_token(prefix_cache):
    run = traced_window(paged_cell(prefix_cache))
    done = [r for r in run.reqs.values() if r.req.completion_time is not None]
    assert len(done) >= 3
    assert check.accounting(run) == [] and check.scheduler(run) == []
    assert all(len(r.tokens) == r.target for r in done)
    assert run.prefills and run.decodes
    assert all(c.flops > 0 for c in run.prefills + run.decodes)
    assert bench.reader("model.decode_mfu")(run) > 0
    open_, close = run.counters
    assert close["engine.step_count"] > open_["engine.step_count"]
    if prefix_cache:
        assert close["engine.n_prefix_hits"] > 0


def test_chunk_flops_add_up_to_the_prompt():
    """A paged prefill in chunks counts what one prefill of the bucket
    counts: the live tokens once each."""
    cell = paged_cell(False)
    run = traced_window(cell)
    fam = cell.reference
    whole = {True: 0.0, False: 0.0}       # prefilled, still prefilling
    for r in run.reqs.values():
        if r.req.dispatch_time is not None:
            n = tokens.prompt_len(r.rec.prompt_tokens, r.bucket)
            whole[bool(r.stamps)] += fam.prefill_flops(cell.sizes, n)
    counted = sum(c.flops for c in run.prefills)
    assert whole[True] > 0
    assert whole[True] - 1 <= counted <= whole[True] + whole[False] + 1


def test_prefix_layout_is_the_engines():
    from repro_torch.configs import smoke_config
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.core.scheduler import DriftScheduler
    cfg = smoke_config("h2o-danube-1.8b")
    buckets = (16, 32, 64)
    engine = ServingEngine(cfg, None, DriftScheduler("sjf"), EngineConfig(
        n_slots=2, max_len=96, prompt_buckets=buckets, paged=True,
        prefix_cache=True), device="cpu")
    content = dict(bench.load_cell("h2o-danube-1.8b.chat.paced")
                   .traffic["content"], shared_prefix_tokens=24)
    for row in traffic.draw_content(content, 40, 7):
        rec = traffic.Record(due=0.0, **row)
        req = harness.make_request(rec)
        bucket = tokens.bucket_for(rec.prompt_tokens, buckets)
        n = tokens.prompt_len(rec.prompt_tokens, bucket)
        want = engine._tokenize(req, bucket, n, engine._shared_eff(req, n))
        assert tokens.prompt_ids(rec, buckets, cfg.vocab, True) \
            == want[0].tolist()
        assert tokens.shared_eff(rec, bucket, True) == engine._shared_eff(req, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_shared_prefix_content_equals_the_port_generator(seed):
    from repro_torch.core.request import Category, TenantTier
    from repro_torch.workload.generator import (GeneratorConfig,
                                                WorkloadGenerator)
    content = dict(bench.load_cell("h2o-danube-1.8b.chat.paced")
                   .traffic["content"], shared_prefix_tokens=64,
                   prefix_groups_per_tenant=3)
    gen = WorkloadGenerator(GeneratorConfig(
        category_weights={Category(k): v for k, v
                          in content["category_weights"].items()},
        tenant_weights={TenantTier[k.upper()]: v for k, v
                        in content["tenant_weights"].items()},
        max_tokens=content["max_tokens"],
        output_noise_sigma=content["output_noise_sigma"],
        shared_prefix_tokens=64, prefix_groups_per_tenant=3))
    rng = random.Random(seed)
    theirs = [gen.make_request(rng) for _ in range(200)]
    ours = [harness.make_request(traffic.Record(due=0.0, **row)) for row
            in traffic.draw_content(content, 200, seed)]
    for a, b in zip(theirs, ours):
        assert (a.prompt, a.prompt_tokens, a.true_output_tokens,
                a.prefix_group, a.shared_prefix_tokens) == (
            b.prompt, b.prompt_tokens, b.true_output_tokens,
            b.prefix_group, b.shared_prefix_tokens)
