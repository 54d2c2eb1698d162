"""The share of the profiled slice in which the device sat idle in gaps
that began while the engine's ``engine.prefill`` span was open, in %: the
gaps of ``harness/profile.py:idle_gaps`` (between the slice's kernels,
copies and fills), charged to the eager prefill when the host was inside
it as the device ran dry.  Moves output_tok_s."""
SPAN = "engine.prefill"


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_s <= 0:
        return None
    # one host thread: the engine's prefill spans follow each other
    spans = sorted((s, t) for n, s, t in tr.spans if n == SPAN)
    if not spans:
        return None        # a program without the engine's spans
    gaps, end = [], tr.t0
    for _, s, t in tr.kernels:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if tr.t0 + tr.window_s > end:
        gaps.append((end, tr.t0 + tr.window_s))
    idle, j = 0.0, 0
    for a, b in gaps:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        if j < len(spans) and spans[j][0] <= a:
            idle += b - a
    return 100.0 * idle / tr.window_s
