"""The port's examples, each run with ``python -m`` (``--device``, default
``cuda``)."""
