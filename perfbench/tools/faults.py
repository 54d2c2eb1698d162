"""Faults planted under the timed path, to see ``correct`` come out false:
passed as ``bench.run(..., on_engine=...)``."""
import numpy as np


def alter_tokens(engine, every: int = 3) -> None:
    """A token altered where it is produced: every ``every``-th sampling
    hands back each row's token plus one."""
    sample, calls = engine._sample, [0]
    vocab = engine.cfg.vocab_size

    def altered(logits, reqs):
        out = np.array(sample(logits, reqs))
        calls[0] += 1
        if calls[0] % every == 0:
            out = (out + 1) % vocab
        return out

    engine._sample = altered
