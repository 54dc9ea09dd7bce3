"""One module a traffic ``mode``: ``setup(run)``, ``window(run, seconds,
t0)``, ``traced(run)``, ``release(run) -> evidence``, ``compare(run,
evidence) -> numbers`` and ``end_to_end(run) -> {metric: value}``."""
