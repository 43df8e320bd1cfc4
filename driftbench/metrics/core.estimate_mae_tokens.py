"""core.estimate_mae_tokens: mean absolute difference between the
scheduler's admission estimate of output tokens
(``Request.estimate.est_output_tokens``, what SJF orders by) and the
tokens the request emitted, over requests completed in the window."""


def read(run):
    errs = [abs(r.req.estimate.est_output_tokens - len(r.tokens))
            for r in run.reqs.values()
            if r.req.completion_time is not None and r.stamps
            and run.t_open <= r.stamps[-1] < run.t_close]
    return sum(errs) / len(errs) if errs else None
