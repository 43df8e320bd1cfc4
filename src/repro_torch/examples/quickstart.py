"""Quickstart: the DriftSched public API in ~40 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

Builds a scheduler, submits a handful of multi-tenant requests, watches
the adaptive token estimator learn runtime token drift (Eq. 1-6), and
shows how the learned bias changes admission-time classification.
"""

from repro_torch.core import (Category, DriftConfig, DriftScheduler, Request,
                        TenantTier)

sched = DriftScheduler(policy="sjf", config=DriftConfig())

print("=== admission-time estimation (static, bias=1.0) ===")
r = Request(tenant=TenantTier.PREMIUM, category=Category.REPORT,
            prompt="Write a detailed incident report on the DNS outage.")
sched.submit(r, now=0.0)
e = r.estimate
print(f"T_base={e.t_base:.0f} B={e.bias:.2f} S={e.safety:.2f} "
      f"F={e.f_input:.2f} -> budget={e.t_budget:.0f} "
      f"class={e.job_class.value}")

# dispatch + completion: the model actually generated far fewer tokens
# than the static estimate (runtime token drift)
req = sched.dispatch(now=0.1)
sched.complete(req, observed_tokens=410, now=5.0)

print("\n=== after feedback, the report bias has adapted ===")
for i in range(30):   # a few more drifting reports
    r = Request(tenant=TenantTier.STANDARD, category=Category.REPORT,
                prompt="Write a full post-incident report covering etcd.")
    sched.submit(r, now=10.0 + i)
    d = sched.dispatch(now=10.0 + i)
    sched.complete(d, observed_tokens=400 + 5 * i, now=12.0 + i)

print("learned bias:", {k: round(v, 3)
                        for k, v in sched.bias_store.snapshot().items()})

r2 = Request(tenant=TenantTier.PREMIUM, category=Category.REPORT,
             prompt="Write a detailed incident report on the DNS outage.")
sched.submit(r2, now=100.0)
e2 = r2.estimate
print(f"new estimate: budget={e2.t_budget:.0f} class={e2.job_class.value} "
      f"(was {e.t_budget:.0f}/{e.job_class.value})")

stats = sched.drift.stats()
print(f"\ndrift so far: n={stats.n} MAE={stats.mae:.1f} "
      f"mean_error={stats.mean_error:+.1f} "
      f"(positive = static over-estimation, the paper's drift direction)")
