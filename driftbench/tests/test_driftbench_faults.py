"""The check that decides ``correct`` fails what it has to fail. A run
of the harness on the CPU at a smoke size (the look for a card is the
CLI's, so it is skipped here): sound, it is correct; with the timed
path broken underneath in each way a serving cell can break, it is not.
The control (the reference one precision lower, fp8) reads wider than
the program."""

import dataclasses
import json
import math

import pytest

from driftbench import check, harness
from driftbench.bench import BENCH, Cell

LIMIT = 0.02     # smoke size: sound runs read ~3e-3, faults ~0.1 and up


def smoke_cell(registry, reference):
    from repro_torch.configs import smoke_config
    cfg = smoke_config(registry)
    model = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
             if f.name not in ("name", "family")}
    if model.get("sliding_window"):
        model["sliding_window"] = 128          # wider than the ring
    traffic = json.loads((BENCH / "traffic" / "chat.paced.json").read_text())
    # short answers, so that many requests finish within a short window
    # however loaded the test machine is, and a queue forms
    traffic["content"]["max_tokens"] = 40
    spec = {"engine": {"n_slots": 2, "max_len": 80,
                       "prompt_buckets": [16, 32, 64],
                       "chunk_prefill_tokens": 128, "paged": False,
                       "temperature": 0.0},
            "policy": "sjf", "rate_per_s": 60.0, "warm_s": 0.3,
            "limits": {"logit_gap": LIMIT}}
    config = {"registry": registry, "family": cfg.family,
              "reference": reference, "model": model}
    return Cell("smoke", registry, "chat.paced", config, traffic, spec, 1)


class StepClock:
    """A clock that advances a fixed tick each time it is read, and by the
    full span of a sleep: a window then holds the same steps on any
    machine, however loaded."""

    def __init__(self, tick=0.005):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t

    def sleep(self, seconds):
        self.t += max(seconds, 0.0)


def window(cell, seed):
    params = harness.draw_weights(cell, seed, "cpu")
    clock = StepClock()
    run = harness.run_window(cell, seed, 1.0, False, "cpu", params, 0.0,
                             clock=clock, sleep=clock.sleep)
    run.engine = None
    return run, params


def run_once(cell, seed=3):
    run, params = window(cell, seed)
    return check.verify(run, cell.reference, params, seed)


def _api_fault(monkeypatch, change):
    """Replace the engine's model API by one whose decode step is
    broken by ``change(orig)``."""
    import repro_torch.serving.engine as eng
    orig_get = eng.get_api

    def get_api(cfg):
        api = orig_get(cfg)
        return dataclasses.replace(api, decode_step=change(api.decode_step))
    monkeypatch.setattr(eng, "get_api", get_api)


def state_unchanged(orig):
    def decode(cfg, params, cache, tokens, pos):
        saved = {k: v.clone() for k, v in cache.items()}
        logits, new = orig(cfg, params, cache, tokens, pos)
        for k, v in saved.items():
            cache[k].copy_(v)
        return logits, cache
    return decode


def half_batch(orig):
    """Half of the lanes (the low slots, which the engine fills first)
    left out of the step."""
    def decode(cfg, params, cache, tokens, pos):
        logits, new = orig(cfg, params, cache, tokens, pos)
        logits = logits.clone()
        logits[:max(logits.shape[0] // 2, 1)] = 0.0
        return logits, new
    return decode


FAMILIES = {"dense": ("h2o-danube-1.8b", "dense"),
            "ssm": ("mamba2-2.7b", "ssm")}
# the model's state and batch faults in both families; the token, the
# accounting and the scheduler are the engine's, shared by both
FAULTS = [("dense", "state_unchanged"), ("ssm", "state_unchanged"),
          ("dense", "half_batch"), ("ssm", "half_batch"),
          ("dense", "token_altered"), ("dense", "target_overrun"),
          ("dense", "dispatch_fifo")]
# the number each fault has to fail
CAUGHT_BY = {"state_unchanged": "logit_gap", "half_batch": "logit_gap",
             "token_altered": "logit_gap", "target_overrun": "accounting",
             "dispatch_fifo": "scheduler"}


@pytest.mark.parametrize("family,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(family, fault, monkeypatch):
    import repro_torch.serving.engine as eng
    from repro_torch.core import policies
    if fault == "state_unchanged":
        _api_fault(monkeypatch, state_unchanged)
    elif fault == "half_batch":
        _api_fault(monkeypatch, half_batch)
    elif fault == "token_altered":
        orig = eng.sample_logits
        monkeypatch.setattr(eng, "sample_logits",
                            lambda lg, g, t: (orig(lg, g, t) + 1) % lg.shape[-1])
    elif fault == "target_overrun":
        orig_admit = eng.ServingEngine._admit

        def admit(self, req, slot, now):
            orig_admit(self, req, slot, now)
            self.slots[slot].target += 1
        monkeypatch.setattr(eng.ServingEngine, "_admit", admit)
    elif fault == "dispatch_fifo":
        monkeypatch.setattr(policies.SjfPolicy, "select",
                            policies.FifoPolicy.select)
    ok, checks, details = run_once(smoke_cell(*FAMILIES[family]))
    caught = checks[CAUGHT_BY[fault]]
    assert not ok and details["sampled"] >= 3, (checks, details)
    assert math.isfinite(caught["value"]) \
        and caught["value"] > caught["limit"], checks


def test_a_fifo_cell_is_checked_against_fifo():
    cell = smoke_cell(*FAMILIES["dense"])
    cell.spec["policy"] = "fifo"
    ok, checks, _ = run_once(cell)
    assert ok, checks


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_sound_run_is_correct_and_the_control_is_not(family):
    cell = smoke_cell(*FAMILIES[family])
    run, params = window(cell, 4)
    fam = cell.reference
    ok, checks, details = check.verify(run, fam, params, 4)
    assert ok and details["sampled"] >= 3, (checks, details)
    per = check.gaps(run, fam, params, check.sample(run, 6, 4), control=True)
    program = max(g for g, _ in per)
    control = max(c for _, c in per)
    assert program < LIMIT < control, (program, control)
