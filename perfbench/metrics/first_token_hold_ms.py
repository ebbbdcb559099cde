"""Batcher: mean time a first token, once the host has it (the start of
``batcher.first_token``, the wait for the prefill's argmax), waits for the
end of the ``batcher.step`` that admitted it, when it reaches the client:
the step's later admissions and its decode step. Over the first tokens of
the window (the program's spans)."""

from perfbench import spans


def read(run):
    steps = spans.by_id(run, "batcher.step")
    admits = spans.by_id(run, "batcher.admit")
    t0, close = spans.window(run)
    holds = []
    for e in spans.events(run, "batcher.first_token"):
        if not t0 <= spans.start(e) < close:
            continue
        admit = admits.get(e["args"]["parent"])
        step = steps.get(admit["args"]["parent"]) if admit else None
        if step is not None:
            holds.append(spans.end(step) - spans.start(e))
    return 1e3 * sum(holds) / len(holds) if holds else None
