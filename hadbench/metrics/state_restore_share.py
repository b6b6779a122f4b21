"""Engine and scheduler: % of the window's fresh admissions (a session's
turns) that restored a pooled state checkpoint, from the flight
recorder's admission rows (``state_restore``, the checkpoint entry
restored, -1 for none). None where the rows do not say, or no turn was
admitted."""
from hadbench import spans


def read(ctx):
    pairs = spans.paired(ctx, ctx.steps)
    if pairs is None:
        return None
    rows = [a for _, ev in pairs for a in ev["admissions"]
            if a.get("resume") == "fresh"]
    if not rows or any("state_restore" not in a for a in rows):
        return None
    return 100.0 * sum(a["state_restore"] >= 0 for a in rows) / len(rows)
