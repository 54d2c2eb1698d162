"""A backlog: before every step the waiting line is topped up to
``backlog * batch_size`` requests (the mix's ``backlog``, default 2), each
due when it is submitted, so every slot stays busy.  Warm-up runs this
loop until as many requests have completed as the batch has slots, so
that the first fill has turned over; the window then opens on that steady
state."""

WARMUP_LIMIT_S = 900.0


def feed(loop, now: float):
    """Submit what is due; the loop always has work, so no next due time."""
    e = loop.engine
    want = int(round(loop.mix.get("backlog", 2) * e.B))
    while len(e.queue) < want:
        loop.submit(next(loop.items), loop.clock())
    return None


def warm(loop) -> None:
    st, b = loop.engine.stats, loop.engine.B
    loop.run_until(loop.clock() + WARMUP_LIMIT_S,
                   stop=lambda: st.completed >= b)
    if st.completed < b:
        raise RuntimeError(f"warm-up completed {st.completed} of {b} "
                           f"requests in {WARMUP_LIMIT_S:.0f} s")
