"""edge_scorer_ms.search (ms/round, lower is better, device trace): the
device time of the edge scorer kernel's rows (names holding "edge_score")
per traced round, where their count equals the launches that
edge_score.edge_scores counted."""

SCORER = "edge_score"


def read(run):
    trace = run.trace
    if trace is None or trace.lost_rows():
        return None
    rows = trace.rows(SCORER)
    if not rows or len(rows) != trace.launches.get(SCORER):
        return None
    return sum(e - s for _, s, e in rows) / 1e6 / trace.units
