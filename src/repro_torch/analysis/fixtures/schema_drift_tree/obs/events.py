"""Fixture schema: EVENT_TYPES reordered against the committed lock
(PROVISION/DRAIN swapped) and HEDGE never emitted by the fixture engine —
both findings anchor on the ``# BAD`` line."""

EVENT_TYPES = ("RENT", "DRAIN", "PROVISION", "REVOKE", "HEDGE")  # BAD
