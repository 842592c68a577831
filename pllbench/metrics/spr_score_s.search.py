"""spr_score_s.search (s/round, lower is better, program span): the score
phase of spr_round (the message sweep, the ball recursion and the edge
scorer), timings["score"] per round, in the traced rounds run without the
profiler.  The phase ends in .cpu() reads of the scores, so its host clock
covers its device work."""


def read(run):
    trace = run.trace
    if trace is None or not trace.spans.get("score"):
        return None
    spans = trace.spans["score"]
    return sum(spans) / len(spans)
