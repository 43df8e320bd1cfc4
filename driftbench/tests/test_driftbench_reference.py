"""The plain references against the port's own plain path, on the CPU
at the smoke sizes: a prompt bucket through ``api.prefill`` into the
slot-ring cache, then decode steps through it, in float32, against the
reference's full forward of the same tokens. Also the fp8 control's
distance, which has to be far wider."""

import dataclasses

import pytest
import torch

from driftbench.gen.traffic import Record
from driftbench.reference import common, dense, ssm, tokens

FAMILIES = [("h2o-danube-1.8b", dense), ("mamba2-2.7b", ssm)]


def _smoke(registry):
    from repro_torch.configs import smoke_config
    cfg = smoke_config(registry)
    if cfg.sliding_window:
        cfg = cfg.replace(sliding_window=128)     # wider than the ring
    return cfg


def _sizes(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("registry,fam", FAMILIES)
def test_reference_matches_prefill_and_slot_ring_decode(registry, fam):
    _against_the_port(_smoke(registry).replace(dtype="float32"), fam)


def test_reference_ties_the_head_as_the_port_does():
    cfg = _smoke("mamba2-2.7b").replace(dtype="float32", tie_embeddings=True)
    p = ssm.draw(_sizes(cfg), torch.Generator().manual_seed(5))
    assert "lm_head" not in p
    _against_the_port(cfg, ssm)


def _against_the_port(cfg, fam):
    from repro_torch.models.registry import get_api
    c = _sizes(cfg)
    p = fam.draw(c, torch.Generator().manual_seed(5))
    p32 = torch.utils._pytree.tree_map(lambda t: t.float(), p)
    api = get_api(cfg)
    rec = Record(due=0.0, tenant="standard", category="short_qa",
                 prompt="Summarize how DNS works.", prompt_tokens=4,
                 max_tokens=8, true_output_tokens=8)
    ids = tokens.prompt_ids(rec, (16, 32), cfg.vocab)
    assert len(ids) == 16 and ids[:12] == [0] * 12
    logits, cache_1 = api.prefill(cfg, p32, {"tokens": torch.tensor([ids])},
                                  max_len=48)
    cache = api.init_cache(cfg, 2, 48, device="cpu")
    for name, full in cache.items():           # the engine's slot insert
        axis = 1 if full.ndim > 1 else 0
        full.select(axis, 1).copy_(cache_1[name].select(axis, 0))
    served, got = [], [logits[0]]
    for _ in range(6):
        nxt = int(got[-1].argmax())
        served.append(nxt)
        step = torch.tensor([0, nxt])
        out, cache = api.decode_step(cfg, p32, cache, step, cache["lens"])
        got.append(out[1])
    seq = torch.tensor(ids + served)
    with common.full_float32():
        ref = fam.logits(c, p, fam.final_hidden(c, p, seq))
    want = ref[len(ids) - 1:]
    assert torch.allclose(torch.stack(got), want, atol=2e-5, rtol=1e-4)
    with common.full_float32():
        low = fam.logits(c, p, fam.final_hidden(c, p, seq, low=True),
                         low=True)
    assert (low - ref).abs().max() > 100 * (torch.stack(got) - want).abs().max()


def test_fp8_rounds_to_e4m3_per_slice():
    x = torch.tensor([[1.0, 448.0], [0.5, 0.26]])
    q = common.fp8(x, -1)
    assert torch.equal(q[0], x[0])
    assert q[1, 0] == 0.5 and abs(q[1, 1] - 0.26) < 0.02


def test_target_and_bucket_rules():
    assert tokens.bucket_for(0, (16, 32)) == 16
    assert tokens.bucket_for(33, (16, 32)) == 32          # clipped
    assert tokens.target(900, 1024, 1090, 64) == 900
    assert tokens.target(1024, 1024, 1090, 64) == 1024
    assert tokens.target(2000, 4096, 100, 64) == 34
    assert tokens.target(0, 10, 100, 16) == 1
