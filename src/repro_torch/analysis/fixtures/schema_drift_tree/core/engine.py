"""Fixture Python engine: emits every type except HEDGE (missing-emit
seed — the finding anchors on the schema line in obs/events.py)."""


class Engine:
    def __init__(self):
        self.recorder = None

    def step(self, t, RENT, PROVISION, DRAIN, REVOKE):
        if self.recorder is not None:
            self.recorder.emit(t, RENT)
            self.recorder.emit(t, PROVISION)
            self.recorder.emit(t, DRAIN)
            self.recorder.emit(t, REVOKE)
