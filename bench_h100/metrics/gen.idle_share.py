"""gen.idle_share: percent of the traced window in which no operation ran
on the device (the union of the device trace's operations)."""


def read(rec):
    return rec.idle_pct()
