"""Host milliseconds a step outside the device waits and the eager chunks'
enqueue: the change of the engine's ``host_s`` (``EngineStats``) summed
over every phase but ``sync.*`` and ``prefill.launch``, over the change of
``host_n["step"]``, across the window.  Moves output_tok_s."""


def read(rec):
    s0, s1 = rec.stats0.get("host_s"), rec.stats1.get("host_s")
    n0, n1 = rec.stats0.get("host_n"), rec.stats1.get("host_n")
    if s1 is None or n1 is None or s0 is None or n0 is None:
        return None        # an engine without host phases
    steps = n1.get("step", 0) - n0.get("step", 0)
    if steps <= 0:
        return None
    host = sum(v - s0.get(k, 0.0) for k, v in s1.items()
               if not k.startswith("sync.") and k != "prefill.launch")
    return 1e3 * host / steps
