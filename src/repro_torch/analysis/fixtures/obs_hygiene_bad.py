"""Seeded obs-hygiene violations: recorder/tracer call sites with no
``is not None`` guard. Every ``# BAD`` line must be flagged."""


class Engine:
    def __init__(self, recorder=None, tracer=None):
        self.recorder = recorder
        self.tracer = tracer

    def step(self, t):
        self.recorder.emit(t, 0)  # BAD
        if t > 0:
            self.tracer.counter("queue_depth", t, 1)  # BAD

    def flush(self, recorder, t):
        recorder.emit(t, 1)  # BAD
