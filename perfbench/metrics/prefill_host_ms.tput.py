"""Host milliseconds to enqueue one eager prefill bucket: the change of the
engine's ``host_s["prefill.launch"]`` over the change of its
``host_n["prefill.launch"]`` (``EngineStats``) across the window.  Moves
output_tok_s."""
KEY = "prefill.launch"


def read(rec):
    s0, s1 = rec.stats0.get("host_s"), rec.stats1.get("host_s")
    n0, n1 = rec.stats0.get("host_n"), rec.stats1.get("host_n")
    if s1 is None or n1 is None or s0 is None or n0 is None:
        return None        # an engine without host phases
    n = n1.get(KEY, 0) - n0.get(KEY, 0)
    if n <= 0:
        return None
    return 1e3 * (s1[KEY] - s0.get(KEY, 0.0)) / n
