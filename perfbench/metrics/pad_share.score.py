"""Share of the rows the scoring window launched that were padding.

Each ``score`` span (one call into ``predict_scores_fast``) counts the
call's useful ``rows`` and the ``rows_padded`` that fill its last batch to
the program's batch size; over the window's calls,
sum(rows_padded) / sum(rows + rows_padded).
"""

from perfbench.lib.program_spans import window_spans


def read(run):
    spans = window_spans(run)
    calls = [s.counts for s in spans or () if s.name == "score" and "rows" in s.counts]
    launched = sum(c["rows"] + c["rows_padded"] for c in calls)
    return 100.0 * sum(c["rows_padded"] for c in calls) / launched if launched else None
