"""Every accepted obs-hygiene guard form — must produce zero findings
(note: no ``# BAD`` markers)."""

from obs_stub import EventRecorder  # fixture import; never executed


class Engine:
    def __init__(self):
        self.recorder = None
        self.tracer = None

    def enclosing_if(self, t):
        if self.recorder is not None:
            self.recorder.emit(t, 0)

    def compound_test(self, t, hot):
        if hot and self.recorder is not None:
            self.recorder.emit(t, 1)

    def ternary(self, t):
        return self.tracer.snapshot() if self.tracer is not None else None

    def early_return(self, recorder, t, delta):
        if recorder is None or delta <= 0:
            return
        for _ in range(delta):
            recorder.emit(t, 2)

    def asserted(self, tracer, t):
        assert tracer is not None
        tracer.counter("q", t, 0)


def locally_constructed(t):
    recorder = EventRecorder()
    recorder.emit(t, 3)
    return recorder
