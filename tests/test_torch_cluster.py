"""The port's engine cluster (``repro_torch.cluster.driver``) against the
JAX package's, stepped in lockstep.

Both drivers run the smoke ``smollm-135m`` in float32 on the CPU, on the
same weights (the JAX init bridged through numpy), over the same seeded
requests (each package's generator, checked equal). Every round both
drivers step at the same simulated time; after it every replica holds
the same last token in every slot, the same active slots and queue
depth, and the same requests are in KV transfer. At the end each
request carries the same stamps (TTFT anchor, handoff, completion), the
same prefill and decode replica and the same steal count, and the
driver counters (handoffs, lost transfers, steals, reroutes, sheds)
agree. On top of that each test asserts on the port what
``tests/test_engine_parity.py`` (the P/D arms) and
``tests/test_cluster_driver.py`` assert on the JAX driver: page
movement and conservation, failure re-prefill, transfer loss, work
stealing, determinism, the shared-estimator refusal and admission
shedding.

The cross-framework handoff moves a prefilled sequence's KV pages from
a JAX prefill engine to a port decode engine, and from a port prefill
engine to a JAX decode engine; both streams of decoded tokens equal the
JAX-only stream.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import AdmissionConfig as JaxAdmissionConfig
from repro.cluster import GlobalAdmission as JaxGlobalAdmission
from repro.cluster.driver import make_engine_cluster as jax_make_cluster
from repro.configs import smoke_config as jax_smoke_config
from repro.core.request import TenantTier as JaxTenantTier
from repro.core.scheduler import DriftScheduler as JaxScheduler
from repro.models import transformer as jax_transformer
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxEngine
from repro.workload.generator import GeneratorConfig as JaxGeneratorConfig
from repro.workload.generator import WorkloadGenerator as JaxGenerator
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.cluster import AdmissionConfig, GlobalAdmission
from repro_torch.cluster.driver import EngineClusterDriver, make_engine_cluster
from repro_torch.cluster.replica import ReplicaRole
from repro_torch.cluster.simulator import ClusterConfig, ClusterSimulator
from repro_torch.configs import smoke_config
from repro_torch.core.request import TenantTier
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.serving.cost_model import L4_QWEN_1_8B
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.workload.generator import (ArrivalPlan, GeneratorConfig,
                                            WorkloadGenerator)

CFG_J = jax_smoke_config("smollm-135m").replace(dtype="float32")
CFG_T = smoke_config("smollm-135m").replace(dtype="float32")
PARAMS_J = jax_transformer.init(CFG_J, jax.random.PRNGKey(0))
PARAMS_T = params_from_numpy(
    CFG_T, jax.tree_util.tree_map(np.asarray, PARAMS_J), device="cpu")

#: the P/D arms' engine shape, as in tests/test_engine_parity.py
BUCKET = 64
PAGE = 8
SLOTS = 4
MAX_TOKENS = 24


def _requests(n, seed, *, max_tokens=MAX_TOKENS, bump=True):
    """The same seeded requests from both packages' generators, checked
    equal; output lengths bumped to >= 2 as the parity suite does."""
    kw = dict(total_requests=n, calibration_requests=n,
              max_tokens=max_tokens, seed=seed)
    jr = [r for _, r in JaxGenerator(JaxGeneratorConfig(**kw))
          .plan(seed=seed).calibration]
    tr = [r for _, r in WorkloadGenerator(GeneratorConfig(**kw))
          .plan(seed=seed).calibration]
    for a, b in zip(jr, tr):
        assert (a.prompt, a.prompt_tokens, a.true_output_tokens,
                a.tenant.label, a.category.value) == \
               (b.prompt, b.prompt_tokens, b.true_output_tokens,
                b.tenant.label, b.category.value)
        if bump:
            a.true_output_tokens = b.true_output_tokens = \
                max(a.true_output_tokens, 2)
    return jr, tr


def _pd_engine(slots=SLOTS, chunk=16):
    return dict(n_slots=slots, max_len=96, prompt_buckets=(BUCKET,),
                paged=True, page_size=PAGE, chunk_prefill_tokens=chunk)


def _clusters(n, ekw, *, jax_admission=None, admission=None, **kw):
    """(JAX driver, port driver) over ``n`` engines each."""
    jd = jax_make_cluster(CFG_J, PARAMS_J, n, policy="fifo",
                          engine_config=JaxEngineConfig(**ekw),
                          admission=jax_admission, **kw)
    td = make_engine_cluster(CFG_T, PARAMS_T, n, policy="fifo",
                             engine_config=EngineConfig(**ekw),
                             admission=admission, device="cpu", **kw)
    return jd, td


def _pd_clusters(n, *, slots=SLOTS, n_prefill=1, kv_base=0.002, **kw):
    return _clusters(n, _pd_engine(slots), routing="pd_disaggregated",
                     n_prefill_replicas=n_prefill, kv_transfer_base=kv_base,
                     kv_transfer_per_token=0.0, **kw)


class Lockstep:
    """Two drivers stepped together, compared after every round."""

    def __init__(self, jd, td, jr, tr):
        self.jd, self.td = jd, td
        self.jr, self.tr = jr, tr
        self.jidx = {r.req_id: i for i, r in enumerate(jr)}
        self.tidx = {r.req_id: i for i, r in enumerate(tr)}
        self.now = 0.0
        self.rounds = 0

    def submit(self):
        """Submit every request to both; the number accepted."""
        accepted = 0
        for i, (a, b) in enumerate(zip(self.jr, self.tr)):
            ok = self.jd.submit(a, 1e-6 * i)
            assert self.td.submit(b, 1e-6 * i) == ok, i
            accepted += ok
        return accepted

    def step(self):
        assert self.td.step(self.now) == self.jd.step(self.now)
        self.check()
        self.now += 1.0
        self.rounds += 1
        assert self.rounds < 20_000, "the clusters failed to drain"

    def check(self):
        for rj, rt in zip(self.jd.replicas, self.td.replicas):
            ej, et = rj.engine, rt.engine
            at = f"round {self.rounds}, replica {rt.rid}"
            assert [s.last_token for s in et.slots] == \
                [s.last_token for s in ej.slots], at
            assert et.active_slots() == ej.active_slots(), at
            assert rt.queue_depth() == rj.queue_depth(), at
            assert (rt.state.value, rt.role.value) == \
                (rj.state.value, rj.role.value), at
        assert sorted(self.tidx[k] for k in self.td._in_transit) == \
            sorted(self.jidx[k] for k in self.jd._in_transit)

    def drain(self):
        while not self.jd._drained():
            self.step()
        assert self.td._drained()

    def fail(self, rid):
        self.jd.fail_replica(rid, self.now)
        self.td.fail_replica(rid, self.now)
        self.check()

    def recover(self, rid):
        self.jd.recover_replica(rid, self.now)
        self.td.recover_replica(rid, self.now)

    def done(self):
        """The port's completed requests, after checking that every
        request's record and every driver counter equal JAX's."""
        def record(drv, idx):
            done = [r for rep in drv.replicas for r in rep.sched.completed]
            return done, sorted(
                (idx[r.req_id], r.observed_output_tokens,
                 r.cached_prompt_tokens, r.prefill_end, r.handoff_time,
                 r.exec_end, r.prefill_rid, r.decode_rid, r.n_steals)
                for r in done)
        dj, rec_j = record(self.jd, self.jidx)
        dt, rec_t = record(self.td, self.tidx)
        assert rec_t == rec_j
        for name in ("n_shed", "n_handoffs", "n_handoffs_lost", "n_stolen",
                     "n_rerouted"):
            assert getattr(self.td, name) == getattr(self.jd, name), name
        for rj, rt in zip(self.jd.replicas, self.td.replicas):
            for name in ("n_routed", "n_handoffs_out", "n_handoffs_in",
                         "n_stolen_in", "n_stolen_away", "n_rerouted_away"):
                assert getattr(rt, name) == getattr(rj, name), (rt.rid, name)
            ej, et = rj.engine, rt.engine
            assert et.prefill_chunk_log == ej.prefill_chunk_log
            assert (et.step_count, et.busy_steps, et.n_prefill_launches) == \
                (ej.step_count, ej.busy_steps, ej.n_prefill_launches)
            if et.ecfg.paged:
                assert et.alloc.free_pages == ej.alloc.free_pages
        return dt


def _run_pd(jr, tr, n=2, **kw):
    ls = Lockstep(*_pd_clusters(n, **kw), jr, tr)
    assert ls.submit() == len(tr)
    ls.drain()
    return ls, ls.done()


def _feedback_phases(drv):
    phases = {}
    for rep in drv.replicas:
        for k, v in rep.sched.phase_feedback_counts.items():
            phases[k] = phases.get(k, 0) + v
    return phases


def _conserved(eng):
    tree = eng.prefix_tree.total_pages() if eng.prefix_tree else 0
    return (eng.alloc.free_pages + eng.ledger.owned_pages() + tree
            == eng.alloc.n_pages)


def _stamp_groups(reqs, stamp):
    """Same-round tie groups of ``stamp``, in time order, as frozensets
    of submission indices."""
    idx = {r.req_id: i for i, r in enumerate(reqs)}
    groups = {}
    for r in reqs:
        groups.setdefault(stamp(r), set()).add(idx[r.req_id])
    return [frozenset(groups[t]) for t in sorted(groups)]


def test_pd_ttft_and_handoff_anchors():
    """Mixed output lengths on one prefill and one decode engine: the
    port's driver equals JAX's, every request prefills on replica 0 and
    decodes on replica 1, and its TTFT anchors and KV arrivals fall in
    the same tie groups as on the port's cluster simulator."""
    jr, tr = _requests(16, seed=11)
    for reqs in (jr, tr):
        for i, r in enumerate(reqs):
            r.true_output_tokens = 3 + (5 * i) % 20
    ls, done = _run_pd(jr, tr)
    assert ls.td.n_handoffs == len(tr) == len(done)
    assert all(r.prefill_rid == 0 and r.decode_rid == 1 for r in done)
    assert all(r.handoff_time is not None and r.handoff_time >= r.prefill_end
               for r in done)
    assert all(r.ttft < r.e2e_latency for r in done)

    _, sim_reqs = _requests(16, seed=11)
    for i, r in enumerate(sim_reqs):
        r.true_output_tokens = 3 + (5 * i) % 20
    plan = ArrivalPlan(
        calibration=[(1e-6 * i, r) for i, r in enumerate(sim_reqs)],
        stress=[], config=GeneratorConfig(total_requests=16,
                                          calibration_requests=16))
    sim = ClusterSimulator(plan, ClusterConfig(
        n_replicas=2, routing="pd_disaggregated", n_prefill_replicas=1,
        scheduler_policy="fifo", batch_capacity=SLOTS, step_engine=True,
        continuous_joins=True, chunk_prefill_tokens=16,
        prefix_page_tokens=PAGE, kv_transfer_base=0.002,
        kv_transfer_per_token=0.0, seed=0),
        cost_model=replace(L4_QWEN_1_8B, jitter_sigma=0.0))
    assert sim.run().run.n_completed == 16
    assert sim.n_handoffs == ls.td.n_handoffs
    for stamp in (lambda r: r.prefill_end, lambda r: r.handoff_time):
        assert _stamp_groups(tr, stamp) == _stamp_groups(sim_reqs, stamp)


def test_pd_page_movement_and_conservation():
    """Prefill runs only on the prefill engine, the decode engine only
    receives pages, drift feedback fires once per request on the decode
    phase, and every page is back in its pool after the drain."""
    jr, tr = _requests(16, seed=13)
    ls, done = _run_pd(jr, tr)
    pre, dec = ls.td.replicas
    assert (pre.role, dec.role) == (ReplicaRole.PREFILL, ReplicaRole.DECODE)
    assert pre.engine.n_prefill_launches > 0
    assert dec.engine.n_prefill_launches == 0
    assert pre.engine.n_decode_launches == 0
    assert sum(n for _, n in pre.engine.prefill_chunk_log) == \
        BUCKET * len(tr)
    assert len(pre.sched.completed) == 0
    assert len(dec.sched.completed) == len(tr)
    assert pre.n_handoffs_out == dec.n_handoffs_in == len(tr)
    assert _feedback_phases(ls.td) == {"decode": len(tr)}
    assert not ls.td._in_transit
    for rep in ls.td.replicas:
        assert rep.engine.alloc.free_pages == rep.engine.alloc.n_pages
        assert rep.engine.ledger.owned_pages() == 0
        assert _conserved(rep.engine)


def test_pd_failure_reprefill():
    """The decode engine dies mid-run: its requests reset, re-prefill
    and finish on the other decode engine, each with one feedback."""
    jr, tr = _requests(14, seed=17)
    ls = Lockstep(*_pd_clusters(3), jr, tr)
    ls.submit()
    while not ls.td.replicas[1].engine.active_slots():
        ls.step()
    ls.fail(1)
    assert ls.td.n_rerouted > 0
    ls.drain()
    done = ls.done()
    assert len(done) == len(tr)
    assert ls.td.n_handoffs > len(tr)
    assert all(r.decode_rid == 2 for r in done if r.handoff_time is not None)
    assert sum(_feedback_phases(ls.td).values()) == len(tr)
    for rep in ls.td.replicas:
        if rep.rid != 1:           # the dead pool keeps its last state
            assert rep.engine.alloc.free_pages == rep.engine.alloc.n_pages


def test_pd_transfer_loss_on_source_failure():
    """A transfer in flight when its prefill engine dies is lost; the
    request prefills again on the surviving prefill engine."""
    jr, tr = _requests(8, seed=19)
    ls = Lockstep(*_pd_clusters(4, n_prefill=2, kv_base=50.0), jr, tr)
    ls.submit()
    while not any(t.src_rid == 0 for t in ls.td._in_transit.values()):
        ls.step()
    ls.fail(0)
    assert ls.td.n_handoffs_lost > 0
    ls.drain()
    done = ls.done()
    assert len(done) == len(tr)
    assert all(r.prefill_rid in (0, 1) for r in done)
    assert any(r.prefill_rid == 1 for r in done)


def test_pd_work_stealing_retransfers_kv():
    """Decode-ready work stolen off a backlogged decode engine moves its
    KV payload again, to the thief, which completes it."""
    jr, tr = _requests(16, seed=23)
    ls = Lockstep(*_pd_clusters(3, slots=2, work_stealing=True,
                                steal_min_depth=2), jr, tr)
    ls.fail(2)            # every handoff piles onto replica 1 meanwhile
    ls.submit()
    while ls.td.replicas[1].queue_depth() < 4:
        ls.step()
    ls.recover(2)
    ls.drain()
    done = ls.done()
    assert len(done) == len(tr)
    assert ls.td.n_stolen > 0
    assert ls.td.replicas[2].n_stolen_in > 0
    stolen = [r for r in done if r.n_steals > 0]
    assert stolen and all(r.decode_rid == 2 for r in stolen)
    for rep in ls.td.replicas:
        assert rep.engine.alloc.free_pages == rep.engine.alloc.n_pages


def test_pd_cluster_determinism():
    """Two identical P/D runs of the port give identical stamps."""
    def one():
        _, tr = _requests(12, seed=29)
        drv = make_engine_cluster(
            CFG_T, PARAMS_T, 2, policy="fifo", routing="pd_disaggregated",
            engine_config=EngineConfig(**_pd_engine()),
            n_prefill_replicas=1, kv_transfer_per_token=0.0, device="cpu")
        for i, r in enumerate(tr):
            assert drv.submit(r, 1e-6 * i)
        assert drv.run_until_drained(max_steps=20_000).n_completed == 12
        idx = {r.req_id: i for i, r in enumerate(tr)}
        return sorted((idx[r.req_id], r.observed_output_tokens,
                       r.prefill_end, r.handoff_time, r.exec_end)
                      for rep in drv.replicas for r in rep.sched.completed)
    assert one() == one()


def test_cluster_refuses_unshared_estimators():
    engines = [ServingEngine(CFG_T, PARAMS_T, DriftScheduler(),
                             EngineConfig(n_slots=2, max_len=96,
                                          prompt_buckets=(16,)),
                             device="cpu")
               for _ in range(2)]
    with pytest.raises(ValueError, match="share one AdaptiveTokenEstimator"):
        EngineClusterDriver(engines)


def _admissions():
    def cfg(tiers, mod):
        return mod(bucket_capacity={t: 400.0 for t in tiers},
                   refill_rate={t: 0.0 for t in tiers})
    return (JaxGlobalAdmission(cfg(JaxTenantTier, JaxAdmissionConfig)),
            GlobalAdmission(cfg(TenantTier, AdmissionConfig)))


@pytest.mark.parametrize("shed", [False, True],
                         ids=["routes_and_completes", "admission_sheds"])
def test_unified_cluster_routes_admits_and_sheds(shed):
    """drift_aware routing over two slot-ring engines, with and without
    a token-bucket front door that sheds part of the traffic."""
    n = 12 if shed else 10
    jr, tr = _requests(n, seed=0, max_tokens=48, bump=False)
    adm_j, adm_t = _admissions() if shed else (None, None)
    ekw = dict(n_slots=2, max_len=96, prompt_buckets=(16,))
    ls = Lockstep(*_clusters(2, ekw, routing="drift_aware",
                             jax_admission=adm_j, admission=adm_t), jr, tr)
    accepted = ls.submit()
    ls.now = ls.td._last_submit
    ls.drain()
    done = ls.done()
    assert len(done) == accepted
    if shed:
        assert 0 < accepted < n
        assert ls.td.n_shed == n - accepted
    else:
        assert accepted == n
        assert all(rep.n_routed > 0 for rep in ls.td.replicas)
        assert sum(ls.td.estimator.bias_store.update_counts().values()) == n


# ----------------------------------------------------------------------
# cross-framework handoff
# ----------------------------------------------------------------------

def _jax_to_port(payload):
    return {k: (tensor_from_numpy(v, "cpu") if k in ("k", "v") else v)
            for k, v in payload.items()}


def _port_to_jax(payload):
    """The port's payload as the JAX engine's: numpy arrays, bfloat16 by
    its 16-bit pattern (torch cannot ``.numpy()`` a bfloat16 tensor)."""
    def arr(t):
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(jnp.bfloat16)
        return t.numpy()
    return {k: (arr(v) if k in ("k", "v") else v)
            for k, v in payload.items()}


def _engine(pkg, ekw):
    if pkg == "jax":
        return JaxEngine(CFG_J, PARAMS_J, JaxScheduler("fifo"),
                         JaxEngineConfig(**ekw))
    return ServingEngine(CFG_T, PARAMS_T, DriftScheduler("fifo"),
                         EngineConfig(**ekw), device="cpu")


def _handoff_stream(pre_pkg, dec_pkg):
    """A prefill engine of ``pre_pkg`` hands every request's KV pages to
    a decode engine of ``dec_pkg`` the moment its first token exists.
    Returns (each round's decode-slot tokens, (request index, observed
    tokens, completion round) in completion order)."""
    jr, tr = _requests(6, seed=31)
    reqs = {"jax": jr, "torch": tr}
    pre, dec = _engine(pre_pkg, _pd_engine()), _engine(dec_pkg, _pd_engine())
    twin = {id(a): b for a, b in zip(reqs[pre_pkg], reqs[dec_pkg])}
    for i, (a, b) in enumerate(zip(reqs[pre_pkg], reqs[dec_pkg])):
        pre.sched.submit(a, 1e-6 * i)
        # priced on the decode side, then taken back off its queue: the
        # request reaches that engine only through a handoff
        dec.sched.submit(b, 1e-6 * i)
    dec.sched.queues.drain()
    convert = {("jax", "torch"): _jax_to_port,
               ("torch", "jax"): _port_to_jax}.get((pre_pkg, dec_pkg),
                                                    lambda p: p)

    def hook(slot, req, now):
        dec.accept_handoff(twin[id(req)], convert(pre.extract_sequence(slot)))
        return True
    pre.handoff_hook = hook

    rounds, now = [], 0.0
    while pre.sched.queue_depth() or pre.active_slots() \
            or dec.sched.queue_depth() or dec.active_slots():
        pre.step(now)
        dec.step(now)
        rounds.append([s.last_token for s in dec.slots])
        now += 1.0
        assert now < 500
    idx = {r.req_id: i for i, r in enumerate(reqs[dec_pkg])}
    done = [(idx[r.req_id], r.observed_output_tokens, r.exec_end)
            for r in dec.sched.completed]
    assert len(done) == 6 and not pre.sched.completed
    return rounds, done


def test_cross_framework_handoff_keeps_the_jax_token_stream():
    want = _handoff_stream("jax", "jax")
    assert _handoff_stream("jax", "torch") == want
    assert _handoff_stream("torch", "jax") == want


def test_extract_and_inject_are_page_copies():
    """The payload holds copies of the source pages (reusing the freed
    pages cannot change it), in the JAX payload's layout, and injection
    writes exactly those values into the destination's pages."""
    jr, tr = _requests(1, seed=37)
    src, dst = _engine("torch", _pd_engine()), _engine("torch", _pd_engine())
    got = {}

    def hook(slot, req, now):
        pages = list(src.ledger.table(slot))
        payload = src.extract_sequence(slot)
        for i, p in enumerate(pages):
            assert torch.equal(payload["k"][:, i], src.pool.k[:, p])
            assert torch.equal(payload["v"][:, i], src.pool.v[:, p])
        src.pool.k[:, pages] = -1.0          # the pages are reused
        got.update(payload=payload, req=req)
        return True
    src.handoff_hook = hook
    src.sched.submit(tr[0], 0.0)
    now = 0.0
    while not got:
        src.step(now)
        now += 1.0
    payload = got["payload"]
    n_pages = -(-BUCKET // PAGE)
    assert tuple(payload["k"].shape) == (CFG_T.n_layers, n_pages, PAGE,
                                         CFG_T.n_kv_heads, CFG_T.d_head)
    assert (payload["k"] != -1.0).all()
    assert payload["seq_len"] == payload["bucket"] == BUCKET
    assert not src.active_slots() and _conserved(src)

    # pages 0..2 taken on the destination: the injected pages differ
    dst.alloc.alloc_raw(3)
    dst.accept_handoff(got["req"], payload)
    req = dst.sched.dispatch(now)
    slot = dst.free_slots()[0]
    dst._admit_prefilled(req, slot, dst.pop_pending_injection(req.req_id),
                         now)
    pages = dst.ledger.table(slot)
    assert min(pages) >= 3
    assert torch.equal(dst.pool.k[:, pages], payload["k"])
    assert torch.equal(dst.pool.v[:, pages], payload["v"])
