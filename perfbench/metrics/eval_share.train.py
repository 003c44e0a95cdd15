"""Share of the window spent in the dev evaluation (host clock).

The ``evaluate`` spans around ``Trainer.evaluate`` (the evaluation of
``train/evaluate.evaluate_classifier`` and its EER, ending in a fetch)
over the window's seconds.
"""


def read(run):
    ev = run.record.total("evaluate")
    return 100.0 * ev / run.window_s if ev > 0 and run.window_s > 0 else None
