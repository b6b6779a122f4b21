"""Host runtime: the interpreter's collections (``gc`` spans), total ms
over the window's steps divided by their count, every step of the window
(profiled and idle ones too)."""
from hadbench import spans


def read(ctx):
    pairs = spans.paired(ctx, ctx.steps)
    if not pairs:
        return None
    return 1e3 * sum(spans.duration(r) for _, ev in pairs
                     for r in ev["spans"] if r[0] == "gc") / len(pairs)
