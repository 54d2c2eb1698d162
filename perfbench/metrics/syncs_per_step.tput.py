"""Calls that block the host on the device, a step: the change of the
engine's ``host_n["sync.*"]`` (``EngineStats``) summed over the sites, over
the change of ``host_n["step"]``, across the window.  Moves
output_tok_s."""


def read(rec):
    n0, n1 = rec.stats0.get("host_n"), rec.stats1.get("host_n")
    if n0 is None or n1 is None:
        return None        # an engine without host phases
    steps = n1.get("step", 0) - n0.get("step", 0)
    if steps <= 0:
        return None
    return sum(v - n0.get(k, 0) for k, v in n1.items()
               if k.startswith("sync.")) / steps
