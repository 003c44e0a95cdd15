"""Share of request time spent in the CAE leg (host clock).

The ``cae_leg`` spans around each ``cae_mse_scores_fast`` call (it ends in
its own fetch) over the ``request`` spans.
"""


def read(run):
    req = run.record.total("request")
    cae = run.record.total("cae_leg")
    return 100.0 * cae / req if req > 0 and cae > 0 else None
